"""Carry weights of the JAX ``HamerLightModel`` and ``HandsLightModel`` into
the port.

:func:`state_dict_from_jax` takes the Flax variables as a nested dict of
numpy arrays and returns a ``state_dict`` for the port's
``models.hamer_light.HamerLightModel`` or
``models.hands_light.HandsLightModel``. It transposes Flax ``Dense`` kernels
(in, out) to (out, in), turns HWIO conv kernels into OIHW, splits the
scan-stacked ViT blocks along their leading depth axis, and maps Flax's
auto-named modules (``Dense_0``, ``Conv_0``, ``BatchNorm_0`` ..., the
shortcut of a residual block last) one-to-one. For WildHands it carries the
``batch_stats`` collection (running mean and variance) beside ``params``; for
a ``quant_int8_static`` HaMeR also the calibrated ``act_scale_*`` vectors.
The port flattens maps in the JAX order (H, W, C), so no dense kernel needs
its rows permuted. Each tensor lands in the dtype of the parameter it fills:
bf16 matmul weights in a bf16 ViT, f32 in the int8 configurations and in the
ResNets, which cast per call. It asserts that every JAX leaf is consumed and
every port parameter (for WildHands also every buffer) is filled.
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


def _conv(jax_path: str, port_path: str, use_bias: bool = False):
    rules = [(f"{port_path}.weight", f"{jax_path}/kernel",
              lambda a: a.transpose(3, 2, 0, 1))]  # HWIO -> OIHW
    if use_bias:
        rules.append((f"{port_path}.bias", f"{jax_path}/bias", None))
    return rules


def _batchnorm(jax_path: str, port_path: str):
    return [(f"{port_path}.weight", f"{jax_path}/scale", None),
            (f"{port_path}.bias", f"{jax_path}/bias", None),
            (f"{port_path}.running_mean", f"batch_stats/{jax_path}/mean", None),
            (f"{port_path}.running_var", f"batch_stats/{jax_path}/var", None)]


def _dense_stack(jax_path: str, port_path: str, n: int):
    """Flax ``Dense_0 .. Dense_{n-1}`` -> ``port_path.0 .. .{n-1}``."""
    return [r for i in range(n)
            for r in _dense(f"{jax_path}/Dense_{i}", f"{port_path}.{i}")]


def _resnet(jax_scope: str, port_path: str, backbone: nn.Module):
    rules = (_conv(f"{jax_scope}/conv_stem", f"{port_path}.conv_stem")
             + _batchnorm(f"{jax_scope}/bn_stem", f"{port_path}.bn_stem"))
    for i, blocks in enumerate(backbone.stages):
        for j, block in enumerate(blocks):
            jb = f"{jax_scope}/stage{i + 1}_block{j}"
            pb = f"{port_path}.stages.{i}.{j}"
            n = 3 if hasattr(block, "conv3") else 2
            names = [(f"conv{k + 1}", f"bn{k + 1}") for k in range(n)]
            if block.down_conv is not None:  # the shortcut comes last
                names.append(("down_conv", "down_bn"))
            for k, (conv, bn) in enumerate(names):
                rules += _conv(f"{jb}/Conv_{k}", f"{pb}.{conv}")
                rules += _batchnorm(f"{jb}/BatchNorm_{k}", f"{pb}.{bn}")
    return rules


def _mha(jax_path: str, port_path: str):
    return ([(f"{port_path}.in_proj_weight", f"{jax_path}/in_proj_kernel",
              lambda a: a.swapaxes(-1, -2)),
             (f"{port_path}.in_proj_bias", f"{jax_path}/in_proj_bias", None)]
            + _dense(f"{jax_path}/out_proj", f"{port_path}.out_proj"))


def _hand_hmr(jax_path: str, port_path: str, head: nn.Module):
    rules = _dense_stack(jax_path, f"{port_path}.cam_init", 3)
    if head.tf_decoder:
        rules += _dense(f"{jax_path}/Dense_3", f"{port_path}.cam_init_pre")
        jl, pl, layer = (f"{jax_path}/tf_hmr_layer",
                         f"{port_path}.tf_hmr_layer", head.tf_hmr_layer)
        for name in ("feat_mlp_dense", "vector_mlp_dense", "dec_linear1",
                     "dec_linear2", "enc_linear1", "enc_linear2"):
            rules += _dense(f"{jl}/{name}", f"{pl}.{name}")
        for name in ("dec_self_attn", "dec_cross_attn", "enc_self_attn"):
            rules += _mha(f"{jl}/{name}", f"{pl}.{name}")
    else:
        jl, pl, layer = (f"{jax_path}/hmr_layer", f"{port_path}.hmr_layer",
                         head.hmr_layer)
        rules += (_dense(f"{jl}/refine0", f"{pl}.refine0")
                  + _dense(f"{jl}/refine1", f"{pl}.refine1"))
    for key, _ in layer.specs:
        rules += _dense(f"{jl}/dec_{key}", f"{pl}.dec.{key}")
    return rules


def _hands_light_rules(model: nn.Module):
    """(port key, JAX path, transform, None) for every leaf of a port
    ``HandsLightModel``; ``batch_stats/...`` paths name that collection."""
    net = model.net
    rules = []
    for scope in ("glb_backbone", "hand_backbone", "backbone_r", "backbone_l"):
        if getattr(net, scope, None) is not None:
            rules += _resnet(scope, f"net.{scope}", getattr(net, scope))
    rules += _hand_hmr("head_r", "net.head_r", net.head_r)
    rules += _hand_hmr("head_l", "net.head_l", net.head_l)
    if net.grasp_classifier is not None:
        rules += _dense_stack("grasp_classifier",
                              "net.grasp_classifier.layers", 4)
    if getattr(net, "feature_conv", None) is not None:
        for k in range(3):
            rules += _conv(f"feature_conv/Conv_{k}",
                           f"net.feature_conv.conv{k}")
        rules += _dense("feature_conv/Dense_0", "net.feature_conv.dense")
    if getattr(net, "depth_head", None) is not None:
        for k in range(len(net.depth_head.convs)):
            rules += _conv(f"depth_head/Conv_{k}", f"net.depth_head.convs.{k}",
                           use_bias=True)
    for name in ("center_head", "corner_head"):
        if getattr(net, name, None) is not None:
            rules += _dense_stack(name, f"net.{name}.layers", 3)
    return [(p, j, f, None) for p, j, f in rules]


def _hamer_rules(model: nn.Module):
    """(port key, JAX path, transform, depth index or None) for every leaf
    of a port ``HamerLightModel``."""
    depth = len(model.net.backbone.blocks)
    head_depth = len(model.net.mano_head.layers)
    quant_static = bool(model.net.backbone.blocks[0].quant_static)
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
    if model.net.grasp_classifier is not None:
        add(_dense_stack("grasp_classifier", "net.grasp_classifier.layers", 4))
    return rules


def state_dict_from_jax(variables: dict, model: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """Flax ``HamerLightModel`` or ``HandsLightModel`` variables ({"params":
    ..., "batch_stats": ...}, numpy leaves) -> a ``state_dict`` for ``model``
    (the port's model of the same family), with each tensor in the dtype and
    on the device of the parameter or buffer it fills."""
    flat = _flatten(variables["params"])
    flat.update(_flatten(variables.get("batch_stats", {}), "batch_stats"))
    target = model.state_dict()
    is_hamer = hasattr(model.net, "mano_head")
    rules = _hamer_rules(model) if is_hamer else _hands_light_rules(model)
    out, used = {}, set()
    for port_key, jax_path, fn, index in rules:
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
    rest = sorted(set(target) - set(out))
    if rest and not is_hamer:
        raise ValueError(f"port buffers not filled: {rest}")
    # HaMeR's head keeps its mean parameters as buffers: the model's own
    for k in rest:
        out[k] = target[k]
    return out
