"""Megatron tensor parallelism on the ViT blocks (port of
``hands_tpu/parallel/sharding.py``).

The JAX package writes the rule as ``NamedSharding``s on the parameter tree
and lets GSPMD insert the all-reduces over the ``model`` axis. Here each
rank holds its shard of every ViT block (:func:`shard_vit_tp`) and the block
runs on it with the all-reduces written out:

- column-parallel, split by output rows: qkv and the MLP's first product
  (``mlp/Dense_0``), with their biases;
- row-parallel, split by input columns: the attention projection and the
  MLP's second product (``mlp/Dense_1``), summed over the ranks before their
  bias and residual are added, once;
- everything else whole on every rank.

The rule is the JAX one (:func:`vit_tp_spec`), read on the JAX leaf name of
each port parameter (the weight converter's map, :func:`jax_leaf_names`).
One layout differs: the JAX rule splits qkv's 3C output columns
contiguously (on two ranks rank 0 holds all of q and half of k; GSPMD
re-lays the heads out behind the scenes), while a rank here takes the
columns {q, k, v} x its heads, so that the attention runs on its own heads
(the same shard size). The rule also names the HaMeR head's ``to_q``,
``to_kv`` and ``to_out``; :func:`shard_vit_tp` shards ViT blocks only, and
those stay whole (their sharding would only spread storage).

A block on its shard: the bf16 ``fused_block`` route runs K3's kernels on the
rank's heads, proj and MLP2 as the GEMM's f32 partial-product form, summed
in f32 (``ops/vit_block.py``: the ``reduce`` hook, :func:`reduce_hook`), and
K4's backward sums the column-parallel products' input gradients before
each LayerNorm backward; the plain route wraps its ``Dense``s in Megatron's
f and g (:func:`copy_to_model`, :func:`reduce_from_model`), so its gradient
is right in f32. The JAX ``replicated_tree`` is not needed: a parameter
that is not sharded stays an ordinary tensor on every rank.

Not ported (ROADMAP queue 1 item 11): tensor parallelism on the int8 blocks
(K5, K6), and its composition with FSDP (``fsdp_tp_shardings``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from hands_tpu_torch.parallel.mesh import AxisGroup, gather_parts, sum_over

# all-reduces the model axis has run since the last reset (forward hooks and
# backward sums alike), for the launch reports
all_reduces = {"n": 0}


def vit_tp_spec(name: str, ndim: int, model_axis: str = "model") -> list:
    """Megatron TP spec (a list) for one JAX leaf name: column-parallel qkv
    / MLP-in, row-parallel attn-proj / MLP-out, None elsewhere (a copy of
    the JAX rule)."""
    spec = [None] * ndim
    if name.endswith("kernel"):
        # column-parallel: split the output features
        if "qkv" in name or "mlp/Dense_0" in name or "to_kv" in name \
                or "to_q" in name:
            spec[-1] = model_axis
        # row-parallel: split the input features (partial sums -> all-reduce
        # after the matmul)
        elif "attn/proj" in name or "mlp/Dense_1" in name \
                or "to_out" in name:
            spec[-2] = model_axis
    elif name.endswith("bias") and (
            "qkv" in name or "mlp/Dense_0" in name):
        spec[-1] = model_axis
    return spec


def jax_leaf_names(model: nn.Module) -> Dict[str, str]:
    """{port parameter name: JAX leaf path} of a ``ViTBackbone`` or a HaMeR
    model, from the weight converter's rules (``utils/from_jax.py``)."""
    from hands_tpu_torch.models.backbones.vit import ViTBackbone
    from hands_tpu_torch.utils import from_jax

    if isinstance(model, ViTBackbone):
        return {p[1:]: j[1:] for p, j, *_ in from_jax._vit("", "", model)}
    return {p: j for p, j, *_ in from_jax._hamer_rules(model)}


def port_dim(jax_name: str, port_ndim: int) -> Optional[int]:
    """The dimension of the port parameter (Dense weights (out, in)) that
    :func:`vit_tp_spec` splits, or None. The JAX spec is right-aligned, so
    the scan's leading depth axis does not matter."""
    spec = vit_tp_spec(jax_name, port_ndim)
    if "model" not in spec:
        return None
    d = spec.index("model")
    return d if port_ndim == 1 else 1 - d  # (in, out) -> (out, in)


@dataclass(frozen=True)
class TPShard:
    """How a parameter is split over the model ranks: ``dim`` of the port
    tensor, ``heads`` > 0 for qkv (its 3C rows as (3, heads, D)), and the
    model group."""
    dim: int
    heads: int
    tp: AxisGroup


def _take(t: torch.Tensor, shard: TPShard) -> torch.Tensor:
    tp = shard.tp
    if shard.heads:  # qkv: rows {q, k, v} x this rank's heads
        per = shard.heads // tp.world
        v = t.reshape(3, shard.heads, -1, *t.shape[1:])
        v = v[:, tp.rank * per:(tp.rank + 1) * per]
        return v.reshape(-1, *t.shape[1:])
    return t.chunk(tp.world, dim=shard.dim)[tp.rank]


def shard_vit_tp(module: nn.Module, tp: AxisGroup) -> nn.Module:
    """Replace the parameters of every ViT block in ``module`` by this
    rank's shard over the model ranks ``tp`` (in place; every rank must hold
    the same values first, and each block's heads and hidden width must
    divide by ``tp.world``). Each sharded parameter carries its
    :class:`TPShard` as ``tp_shard``. Returns ``module``."""
    from hands_tpu_torch.models.backbones.vit import ViTBackbone

    for bb in [m for m in module.modules() if isinstance(m, ViTBackbone)]:
        names = jax_leaf_names(bb)
        for i, block in enumerate(bb.blocks):
            if block.quant_int8 or block.quant_static:
                raise NotImplementedError(
                    "tensor parallelism on the int8 blocks (K5, K6) is not "
                    "ported: ROADMAP queue 1 item 11 (Parallel axes)")
            heads, hidden = block.num_heads, block.mlp.fc1.weight.shape[0]
            if heads % tp.world or hidden % tp.world:
                raise ValueError(f"{heads} heads, hidden {hidden}: not "
                                 f"divisible by {tp.world} model ranks")
            for name, p in list(block.named_parameters()):
                jax = names[f"blocks.{i}.{name}"]
                d = port_dim(jax, p.ndim)
                if d is None:
                    continue
                shard = TPShard(d, heads if "qkv" in jax else 0, tp)
                owner = block.get_submodule(name.rsplit(".", 1)[0])
                local = nn.Parameter(_take(p.detach(), shard).clone(),
                                     requires_grad=p.requires_grad)
                local.tp_shard = shard
                setattr(owner, name.rsplit(".", 1)[1], local)
            block.set_tp(tp, heads // tp.world)
    return module


def tp_shard_of(p: torch.Tensor) -> Optional[TPShard]:
    return getattr(p, "tp_shard", None)


def full_tp(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's shard laid out as
    parameter ``like`` (a collective over its model ranks: every rank
    calls), or ``local`` where ``like`` is whole."""
    shard = tp_shard_of(like)
    if shard is None:
        return local
    parts = gather_parts(local.detach(), shard.tp)
    if shard.heads:
        per = shard.heads // shard.tp.world
        parts = [q.reshape(3, per, -1, *q.shape[1:]) for q in parts]
        return torch.cat(parts, dim=1).reshape(-1, *local.shape[1:])
    return torch.cat(parts, dim=shard.dim)


def tp_shard_shapes(module: nn.Module) -> Dict[str, tuple]:
    """{parameter name: (local shape, whole shape)} of the sharded
    parameters of ``module``."""
    out = {}
    for name, p in module.named_parameters():
        shard = tp_shard_of(p)
        if shard is not None:
            full = list(p.shape)
            full[shard.dim] *= shard.tp.world
            out[name] = (tuple(p.shape), tuple(full))
    return out


# ------------------------------------------------------------- the moves
def reduce_hook(tp: AxisGroup):
    """The ``reduce`` of ``ops/vit_block.py``: a fresh f32 tensor summed over
    the model ranks in place (one all-reduce; none on one rank)."""
    def reduce(t: torch.Tensor) -> torch.Tensor:
        if tp.world > 1:
            dist.all_reduce(t, group=tp.group)
            all_reduces["n"] += 1
        return t
    return reduce


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        all_reduces["n"] += ctx.tp.world > 1
        return None, sum_over(g, ctx.tp)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the ranks forward, identity backward."""

    @staticmethod
    def forward(ctx, tp, x):
        all_reduces["n"] += tp.world > 1
        return sum_over(x, tp)

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to_model(x: torch.Tensor, tp: AxisGroup) -> torch.Tensor:
    """The input of a column-parallel product (every rank holds it whole)."""
    return _CopyToModel.apply(tp, x)


def reduce_from_model(x: torch.Tensor, tp: AxisGroup) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over the ranks."""
    return _ReduceFromModel.apply(tp, x)
