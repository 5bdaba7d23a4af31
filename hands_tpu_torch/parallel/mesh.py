"""The data-parallel mesh (port of ``hands_tpu/parallel/mesh.py``).

The JAX package trains data-parallel by placing one batch-sharded global
array on a ``("data",)`` mesh; XLA then takes BatchNorm's moments over the
global batch and inserts the gradient ``psum``. Here each process is one rank
of a ``torch.distributed`` group and holds its rows of every global batch
(:func:`shard_batch`); the step reduces the gradients itself
(``train/step.py``), and while it runs (:func:`data_parallel`) BatchNorm
all-reduces its two moments (``models/backbones/resnet.py``) and dropout
takes this rank's rows of the mask one process would draw for the global
batch (``models/heads/hmr.py``). So a step over n ranks equals the
one-process step on the global batch, up to the order of its sums.

Only the data axis is ported: a mesh with another axis (the JAX trainer
accepts ``("data", "model")`` and replicates over ``model``) is ROADMAP queue
1 item 11's remainder, with tensor, sequence and pipeline parallelism.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def resolve_shape(mesh_shape: Sequence[int], world: int) -> list:
    """``mesh_shape`` with its ``-1`` replaced as the JAX ``make_mesh`` does:
    the world over the product of the other axes."""
    shape = list(mesh_shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = world // max(known, 1)
    return shape


def check_data_axes(mesh_shape: Sequence[int],
                    axis_names: Sequence[str]) -> None:
    """Refuse what is not ported: any axis but one ``"data"`` axis."""
    if tuple(axis_names) != ("data",) or len(tuple(mesh_shape)) != 1:
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)} over axes {tuple(axis_names)}: only "
            f"the data axis is ported; tensor, sequence and pipeline axes are "
            f"ROADMAP queue 1 item 11")


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda"):
    """A one-axis ``DeviceMesh`` over every rank of the default group (the
    process group must be up). ``-1`` resolves to the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    check_data_axes(mesh_shape, axis_names)
    world = dist.get_world_size()
    shape = resolve_shape(mesh_shape, world)
    if shape[0] != world:
        raise ValueError(f"mesh of {shape[0]} ranks over a world of {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def rows(n_global: int, rank: int, world: int) -> slice:
    """This rank's rows of a global batch of ``n_global``."""
    if n_global % world:
        raise ValueError(f"batch {n_global} not divisible by {world} ranks")
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of a global batch: every tensor, array and list of a
    (possibly nested) dict / tuple takes rows ``rows(len, rank, world)`` of
    its leading axis; 0-d values and scalars are kept whole (replicated)."""
    if isinstance(batch, dict):
        return type(batch)({k: shard_batch(v, rank, world)
                            for k, v in batch.items()})
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, rank, world) for v in batch)
    if isinstance(batch, list):
        return batch[rows(len(batch), rank, world)]
    if isinstance(batch, (torch.Tensor, np.ndarray)) and batch.ndim > 0:
        return batch[rows(batch.shape[0], rank, world)]
    return batch


@dataclass(frozen=True)
class DataGroup:
    """The ranks a data-parallel step runs over."""
    group: Optional[object]
    rank: int
    world: int


_ACTIVE: Optional[DataGroup] = None
BUCKET_BYTES = 32 * 2 ** 20  # a collective's flat copy, as DDP's buckets


@contextlib.contextmanager
def data_parallel(dp: Optional[DataGroup]) -> Iterator[None]:
    """While the block runs, BatchNorm in train mode and dropout act on the
    global batch of ``dp`` (``None``: one process, nothing changes)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, dp
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[DataGroup]:
    """The data group of the running step, if it spans more than one rank."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.world > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: the gradient of each rank's input
    is the sum over the ranks of the output's gradients."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def all_reduce_sum(x: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """``x`` summed over the ranks of ``dp``, with a gradient."""
    return _AllReduceSum.apply(dp.group, x)


def reduce_mean_(tensors, dp: Optional[DataGroup],
                 bucket_bytes: int = BUCKET_BYTES) -> None:
    """All-reduce ``tensors`` in place to their mean over the ranks, in
    buckets (one flat copy a bucket), as DDP's reducer does; nothing on one
    process."""
    def mean(flat):
        dist.all_reduce(flat, group=dp.group)
        flat.mul_(1.0 / dp.world)

    _bucketed(tensors, dp, mean, bucket_bytes)


def broadcast_(tensors, dp: Optional[DataGroup], src: int = 0,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place, in
    buckets; nothing on one process."""
    _bucketed(tensors, dp,
              lambda flat: dist.broadcast(flat, src, group=dp.group),
              bucket_bytes)


def _bucketed(tensors, dp, collective, bucket_bytes) -> None:
    """``collective`` on one flat copy of each bucket of ``tensors``, the
    result copied back into them."""
    if dp is None or not tensors:
        return
    with torch.no_grad():
        for bucket in _buckets(list(tensors), bucket_bytes):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            collective(flat)
            offset = 0
            for t in bucket:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def _buckets(tensors, bucket_bytes):
    """Consecutive runs of ``tensors`` of one dtype and device, each under
    ``bucket_bytes`` (a larger tensor is a bucket of its own)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (size + nbytes > bucket_bytes or t.dtype != cur[0].dtype
                    or t.device != cur[0].device):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out

