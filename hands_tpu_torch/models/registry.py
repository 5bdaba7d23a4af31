"""Model factory keyed by method name (port of
``hands_tpu/models/registry.py``; ``hamer_light`` only so far)."""

from __future__ import annotations

import math

import torch
from torch import nn

from hands_tpu_torch.config import Config
from hands_tpu_torch.core.xdict import XDict

_NOT_PORTED = {
    "hands_light": "ROADMAP queue 1 item 1 (WildHands forward)",
    "hands": "ROADMAP queue 1 item 1 (WildHands forward)",
    "arctic_sf_light": "ROADMAP queue 1 item 10",
    "arctic_sf": "ROADMAP queue 1 item 10",
    "handoccnet_light": "ROADMAP queue 1 item 10",
    "handoccnet": "ROADMAP queue 1 item 10",
}


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn as Flax's initialisers draw them:
    lecun-normal dense and conv kernels, zero biases, unit LayerNorm scales,
    N(0, 0.02) ViT position embeddings, N(0, 1) decoder query embedding,
    unit static activation scales."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "patch_bias"):
            p.zero_()
        elif leaf == "scale" or leaf.startswith("act_scale_"):
            p.fill_(1.0)  # act_scale_*: until calibration fills them
        else:
            if leaf == "pos_embed":
                std = 0.02
            elif leaf == "pos_embedding":
                std = 1.0
            else:  # (out, in[, kh, kw]) kernels
                std = 1.0 / math.sqrt(p[0].numel())
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device)
            p.copy_(draw * std)
    return model


def fetch_model(cfg: Config, device="cuda", seed: int = 0,
                vit_variant: str = "h") -> nn.Module:
    """Build the model for ``cfg.method`` on ``device`` (the card unless the
    caller names the CPU; without a card that raises) with random weights
    from ``seed`` (load trained weights with ``load_state_dict``, e.g. from
    ``hands_tpu_torch.utils.from_jax``)."""
    method = cfg.method
    if method in ("hamer_light", "hamer"):
        from hands_tpu_torch.models.hamer_light import HamerLightModel

        model = HamerLightModel(cfg, vit_variant=vit_variant, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_weights_(model, gen).eval()
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method '{method}' is not ported yet: {_NOT_PORTED[method]}")
    raise KeyError(f"unknown method '{method}'")


@torch.inference_mode()
def inference_pose(model, inputs, meta_info) -> XDict:
    """Single-batch inference: run the model and return the merged
    ``{inputs.*, pred.*, meta_info.*}`` XDict."""
    pred = model(inputs, meta_info)
    out = XDict()
    out.merge(XDict(inputs).prefix("inputs."))
    out.merge(XDict(pred).prefix("pred."))
    out.merge(XDict(meta_info).prefix("meta_info."))
    return out
