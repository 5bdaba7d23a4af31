"""Carry weights of the JAX ``HamerLightModel`` into the port.

:func:`state_dict_from_jax` takes the Flax variables as a nested dict of
numpy arrays and returns a ``state_dict`` for the port's
``models.hamer_light.HamerLightModel``. It transposes Flax ``Dense`` kernels
(in, out) to (out, in), turns HWIO conv kernels into OIHW, splits the
scan-stacked ViT blocks along their leading depth axis, and maps Flax's
auto-named modules (``Dense_0``, ``LayerNorm_0`` ...) one-to-one. For a
``quant_int8_static`` model it also carries the calibrated ``act_scale_*``
vectors. Each tensor lands in the dtype of the parameter it fills: bf16
matmul weights in a bf16 backbone, f32 in the int8 configurations, whose
kernels quantise from the f32 values. It asserts that every JAX leaf is
consumed and every port parameter is filled.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _dense(jax_path: str, port_path: str, use_bias: bool = True):
    rules = [(f"{port_path}.weight", f"{jax_path}/kernel",
              lambda a: a.swapaxes(-1, -2))]
    if use_bias:
        rules.append((f"{port_path}.bias", f"{jax_path}/bias", None))
    return rules


def _layernorm(jax_path: str, port_path: str):
    return [(f"{port_path}.scale", f"{jax_path}/scale", None),
            (f"{port_path}.bias", f"{jax_path}/bias", None)]


def _rules(depth: int, head_depth: int, quant_static: bool):
    """(port key, JAX path, transform, depth index or None) for every leaf."""
    rules = []

    def add(items, index=None):
        rules.extend((p, j, f, index) for p, j, f in items)

    add(_dense("kpe/Dense_0", "net.kpe.fc1"))
    add(_dense("kpe/Dense_1", "net.kpe.fc2"))
    bb = "net.backbone"
    add([(f"{bb}.patch_embed.weight", "backbone/patch_embed/kernel",
          lambda a: a.transpose(3, 2, 0, 1)),  # HWIO -> OIHW
         (f"{bb}.patch_bias", "backbone/patch_embed/bias", None),
         (f"{bb}.pos_embed", "backbone/pos_embed", None)])
    add(_layernorm("backbone/last_norm", f"{bb}.last_norm"))
    jb = "backbone/blocks/block"
    for i in range(depth):
        pb = f"{bb}.blocks.{i}"
        add(_layernorm(f"{jb}/norm1", f"{pb}.norm1")
            + _layernorm(f"{jb}/norm2", f"{pb}.norm2")
            + _dense(f"{jb}/attn/qkv", f"{pb}.attn.qkv")
            + _dense(f"{jb}/attn/proj", f"{pb}.attn.proj")
            + _dense(f"{jb}/mlp/Dense_0", f"{pb}.mlp.fc1")
            + _dense(f"{jb}/mlp/Dense_1", f"{pb}.mlp.fc2"), index=i)
        if quant_static:  # calibrated activation scales, stacked (depth, C)
            add([(f"{pb}.act_scale_{p}", f"{jb}/act_scale_{p}", None)
                 for p in ("qkv", "proj", "mlp1", "mlp2")], index=i)
    mh = "net.mano_head"
    add(_dense("mano_head/token_proj", f"{mh}.token_proj")
        + [(f"{mh}.pos_embedding", "mano_head/pos_embedding", None)]
        + _dense("mano_head/decpose", f"{mh}.decpose")
        + _dense("mano_head/decshape", f"{mh}.decshape")
        + _dense("mano_head/deccam", f"{mh}.deccam"))
    for i in range(head_depth):
        jl, pl = f"mano_head/layer{i}", f"{mh}.layers.{i}"
        for j in range(3):
            add(_layernorm(f"{jl}/LayerNorm_{j}", f"{pl}.norm{j}"))
        for jatt, patt in ((f"{jl}/self_attn/attn", f"{pl}.self_attn"),
                           (f"{jl}/cross_attn", f"{pl}.cross_attn")):
            add(_dense(f"{jatt}/to_q", f"{patt}.to_q", use_bias=False)
                + _dense(f"{jatt}/to_kv", f"{patt}.to_kv", use_bias=False)
                + _dense(f"{jatt}/to_out", f"{patt}.to_out"))
        add(_dense(f"{jl}/Dense_0", f"{pl}.fc1")
            + _dense(f"{jl}/Dense_1", f"{pl}.fc2"))
    return rules


def state_dict_from_jax(variables: dict, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """Flax ``HamerLightModel`` variables ({"params": ...}, numpy leaves) ->
    a ``state_dict`` for ``model`` (a port ``HamerLightModel``), with each
    tensor in the dtype and on the device of the parameter it fills."""
    flat = _flatten(variables["params"])
    target = model.state_dict()
    depth = len(model.net.backbone.blocks)
    head_depth = len(model.net.mano_head.layers)
    out, used = {}, set()
    quant_static = bool(model.net.backbone.blocks[0].quant_static)
    for port_key, jax_path, fn, index in _rules(depth, head_depth,
                                                quant_static):
        a = flat[jax_path]
        used.add(jax_path)
        if index is not None:
            a = a[index]
        if fn is not None:
            a = fn(a)
        ref = target[port_key]
        t = torch.from_numpy(np.array(a, np.float32))  # a writable copy
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{jax_path} -> {port_key}: shape "
                             f"{tuple(t.shape)} != {tuple(ref.shape)}")
        out[port_key] = t.to(device=ref.device, dtype=ref.dtype)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"JAX leaves not consumed: {unused}")
    params = {k for k, _ in model.named_parameters()}
    missing = sorted(params - set(out))
    if missing:
        raise ValueError(f"port parameters not filled: {missing}")
    # buffers (mean params) are not parameters; keep the model's own
    for k in set(target) - set(out):
        out[k] = target[k]
    return out
