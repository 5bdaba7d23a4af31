"""Static int8 activation-scale calibration (port of
``hands_tpu/ops/calibration.py``).

The dynamic W8A8 block computes a per-token max-abs and a rescale at each of
its four quantisation points on every call. Offline calibration replaces
that:

1. run representative batches through the plain bf16 path of a model built
   with ``quant_calibrate=True``: each block keeps the running per-channel
   maxima of its four quantisation points (qkv-in, proj-in, mlp1-in,
   mlp2-in) in its ``amax_*`` buffers (``models/backbones/vit.py``; the JAX
   package sows them into a Flax collection instead),
2. convert the maxima to symmetric scales (amax / 127, with an optional
   safety margin for unseen data),
3. inject them into the ``act_scale_*`` parameters of a model built with
   ``quant_static=True``, whose blocks then run
   ``vit_block_fused_int8_static``.

The scale dicts are ``{qkv, proj, mlp1, mlp2}`` -> (depth, channels) f32, the
JAX package's stacked layout, so a file of scales serves both packages.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from hands_tpu_torch.models.backbones.vit import QUANT_POINTS as _POINTS


def _blocks(backbone: nn.Module):
    blocks = list(backbone.blocks)
    if not blocks:
        raise ValueError("backbone has no blocks")
    return blocks


def reset_amax(backbone: nn.Module) -> None:
    """Zero the running maxima of a ``quant_calibrate`` backbone."""
    for blk in _blocks(backbone):
        for p in _POINTS:
            getattr(blk, f"amax_{p}").zero_()


def extract_amax(backbone: nn.Module) -> Dict[str, torch.Tensor]:
    """The four per-block running maxima of a ``quant_calibrate`` backbone,
    stacked: {point: (depth, channels) f32}."""
    blocks = _blocks(backbone)
    if not blocks[0].quant_calibrate:
        raise ValueError("extract_amax needs a backbone built with "
                         "quant_calibrate=True")
    return {p: torch.stack([getattr(b, f"amax_{p}").clone() for b in blocks])
            for p in _POINTS}


def amax_to_scales(amax: Dict[str, torch.Tensor], margin: float = 1.0,
                   eps: float = 1e-6) -> Dict[str, torch.Tensor]:
    """Running maxima -> symmetric per-channel int8 scales (x ~= q * s).

    ``margin`` > 1 leaves headroom for activations outside the calibration
    set (they clip otherwise); 1.0 = exact calibration-set coverage."""
    return {k: torch.clamp(torch.as_tensor(v, dtype=torch.float32) * margin,
                           min=eps) / 127.0
            for k, v in amax.items()}


def merge_amax(a: Optional[Dict[str, torch.Tensor]],
               b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Running-max merge across calibration batches."""
    if a is None:
        return {k: torch.as_tensor(v) for k, v in b.items()}
    return {k: torch.maximum(a[k], b[k]) for k in b}


@torch.no_grad()
def inject_scales(backbone: nn.Module, scales: Dict[str, torch.Tensor]
                  ) -> None:
    """Set the ``act_scale_*`` parameters of a ``quant_static`` backbone to
    the calibrated (depth, channels) values, in place, and drop the blocks'
    prepared int8 operands so that they are folded again."""
    blocks = _blocks(backbone)
    for p in _POINTS:
        want = (len(blocks),) + tuple(
            getattr(blocks[0], f"act_scale_{p}").shape)
        got = tuple(scales[p].shape)
        if want != got:
            raise ValueError(f"scales[{p!r}]: shape {got}, want {want}")
    for i, blk in enumerate(blocks):
        for p in _POINTS:
            slot = getattr(blk, f"act_scale_{p}")
            slot.copy_(torch.as_tensor(scales[p][i]).to(slot))
        blk.invalidate_prepared()


@torch.no_grad()
def calibrate(forward_fn: Callable, backbone_cal: nn.Module,
              batches: Iterable, *, margin: float = 1.0
              ) -> Dict[str, torch.Tensor]:
    """Full calibration loop: ``forward_fn(batch)`` must run the network
    that holds ``backbone_cal`` (built with ``quant_calibrate=True``).
    Returns the scale dict; give it to :func:`inject_scales`."""
    amax = None
    for batch in batches:
        reset_amax(backbone_cal)
        forward_fn(batch)
        amax = merge_amax(amax, extract_amax(backbone_cal))
    if amax is None:
        raise ValueError("calibrate() needs at least one batch")
    return amax_to_scales(amax, margin=margin)
