"""Fully-sharded data parallelism (port of ``hands_tpu/parallel/fsdp.py``) on
FSDP2's ``fully_shard``.

Each parameter large enough lives sharded over the data ranks, and the
optimiser's Adam moments (and accumulated gradient) are made from the local
shard, so they follow it. FSDP2 all-gathers a unit's parameters before its
forward and again before its backward, and reduce-scatters its gradients to
their mean over the ranks. The unit is one ViT block or one ResNet stage,
plus the root for what is left; K4's ``autograd.Function`` saves its block's
parameters for the recompute in its backward, and the block as the unit makes
them the gathered ones again when that backward runs.

The shard rule is the JAX ``fsdp_spec`` (:func:`fsdp_dim`): the largest
dimension that divides the world, the trailing one on ties (rank >= 3 leaves
avoid their leading axis when another divides); leaves under
``MIN_SHARD_ELEMS`` elements, and leaves no dimension of which divides, stay
whole on every rank (``ignored_params``: the step all-reduces their
gradients). The rule is read in the JAX layout of each leaf
(:func:`jax_order`: Dense kernels are (in, out) there, convolutions HWIO), so
a tie falls on the dimension the JAX package shards. The JAX ViT stacks its
blocks along a leading depth axis, which the port's per-block leaves do not
have: their size is counted per block.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

# Leaves smaller than this stay whole: gathering a 5 KB bias costs more in
# collective latency than its shard saves.
MIN_SHARD_ELEMS = 2 ** 14


def fsdp_dim(shape: Sequence[int], n: int,
             min_shard_elems: int = MIN_SHARD_ELEMS) -> Optional[int]:
    """The dimension of ``shape`` (a JAX-layout shape) that the JAX
    ``fsdp_spec`` shards over ``n`` ranks, or ``None`` (whole)."""
    if n <= 1 or not shape or math.prod(shape) < min_shard_elems:
        return None
    divisible = [i for i in range(len(shape)) if shape[i] % n == 0]
    if len(shape) >= 3 and len(divisible) > 1 and 0 in divisible:
        divisible.remove(0)
    if not divisible:
        return None
    return max(divisible, key=lambda i: (shape[i], i))


def jax_order(name: str, shape: Sequence[int]) -> List[int]:
    """The port's dimensions of a parameter in the order of its JAX leaf:
    convolution kernels OIHW <- HWIO, 2-D ``weight``s (Dense kernels) are
    transposed; anything else keeps its layout."""
    if len(shape) == 4:
        return [2, 3, 1, 0]
    if len(shape) == 2 and name.rsplit(".", 1)[-1] == "weight":
        return [1, 0]
    return list(range(len(shape)))


def shard_dim(name: str, shape: Sequence[int], n: int,
              min_shard_elems: int = MIN_SHARD_ELEMS) -> Optional[int]:
    """The port dimension :func:`fsdp_dim` picks for parameter ``name``."""
    order = jax_order(name, shape)
    d = fsdp_dim([shape[i] for i in order], n, min_shard_elems)
    return None if d is None else order[d]


def shard_units(model: nn.Module) -> List[object]:
    """The units of ``fully_shard``, innermost first: every ViT ``Block``
    and every ResNet stage (the list of its blocks)."""
    from hands_tpu_torch.models.backbones.resnet import ResNet
    from hands_tpu_torch.models.backbones.vit import Block

    units: List[object] = []
    for module in model.modules():
        if isinstance(module, Block):
            units.append(module)
        elif isinstance(module, ResNet):
            units.extend(list(stage) for stage in module.stages)
    return units


def shard_model(model: nn.Module, mesh) -> None:
    """``fully_shard`` the units of :func:`shard_units` and the root over
    ``mesh`` (one ``"data"`` axis) by the rule of :func:`shard_dim`. Every
    rank must hold the same values first. A model that tensor parallelism
    shards is refused (the FSDP x TP hybrid is ROADMAP item 11's)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from hands_tpu_torch.parallel.sharding import tp_shard_of

    if any(tp_shard_of(p) is not None for p in model.parameters()):
        raise NotImplementedError(
            "FSDP over a tensor-parallel model (the JAX fsdp_tp_shardings "
            "hybrid) is not ported: ROADMAP queue 1 item 11 (Parallel axes)")
    dims, whole = {}, set()
    for name, p in model.named_parameters():
        d = shard_dim(name, p.shape, mesh.size())
        if d is None:
            whole.add(p)
        else:
            dims[p] = d
    for unit in shard_units(model) + [model]:
        fully_shard(unit, mesh=mesh,
                    shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params=whole)


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's own part of ``t``: its shard of a sharded tensor (an alias
    of its storage), or ``t``."""
    if is_sharded(t):
        with torch.no_grad():
            return t.to_local()
    return t


def full(local_t: torch.Tensor, like) -> torch.Tensor:
    """The whole tensor of which ``local_t`` is this rank's shard laid out as
    parameter ``like`` (a collective under FSDP: every rank calls it), or
    ``local_t`` where ``like`` is whole. One ``all_gather`` of the shards
    (``DTensor.full_tensor`` goes through the functional collectives, which
    crash the process with gloo on CUDA tensors in torch 2.11)."""
    if not is_sharded(like):
        return local_t
    import torch.distributed as dist

    (placement,) = like.placements
    mesh = like.device_mesh
    parts = [torch.empty_like(local_t) for _ in range(mesh.size())]
    dist.all_gather(parts, local_t.contiguous(), group=mesh.get_group())
    return torch.cat(parts, dim=placement.dim)


def shard_of(whole_t: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard, laid out as parameter ``like``, of a whole tensor
    that every rank holds (no communication)."""
    if not is_sharded(like):
        return whole_t
    (placement,) = like.placements
    mesh = like.device_mesh
    return torch.chunk(whole_t, mesh.size(), dim=placement.dim)[
        mesh.get_local_rank()]


def shard_bytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (a module's parameters, or a
    list of tensors, sharded or whole)."""
    if isinstance(tensors, nn.Module):
        tensors = list(tensors.parameters())
    return sum(local(t).numel() * t.element_size() for t in tensors)
