"""Meshes of ranks and the collectives of the parallel axes (port of
``hands_tpu/parallel/mesh.py``).

The JAX package places arrays on a ``jax.sharding.Mesh`` and lets XLA insert
the collectives. Here each process is one rank of a ``torch.distributed``
group. :func:`make_mesh` lays the ranks out as the JAX ``make_mesh`` lays out
its devices (``-1`` resolved, row-major, as ``np.reshape``) and brings up one
process group per line of each axis; :meth:`Mesh.axis` is this rank's
:class:`AxisGroup` on an axis. On a ``("data", "model")`` mesh of (1, 2),
ranks 0 and 1 form one ``model`` group and each is a ``data`` group alone.

**The data axis.** The JAX package trains data-parallel by placing one
batch-sharded global array on the ``"data"`` axis; XLA then takes BatchNorm's
moments over the global batch and inserts the gradient ``psum``. Here each
rank holds its rows of every global batch (:func:`shard_batch`); the step
reduces the gradients itself (``train/step.py``), and while it runs
(:func:`data_parallel`) BatchNorm all-reduces its two moments
(``models/backbones/resnet.py``) and dropout takes this rank's rows of the
mask one process would draw for the global batch (``models/heads/hmr.py``).
So a step over n ranks equals the one-process step on the global batch, up
to the order of its sums.

**The model axes** (``parallel/{sharding,sequence,pipeline}.py``) move
activations with two differentiable collectives: :func:`ppermute` (the
JAX ``lax.ppermute`` by a shift) and :func:`all_gather` (``lax.all_gather``,
tiled). gloo carries CUDA tensors through the host in its collectives, but
point-to-point ``send``/``recv`` of CUDA tensors is not relied on: the hop
of :func:`ppermute` is an all-gather of which each rank keeps its source's
part (n times the bytes of a send on n ranks). A bf16 or f16 tensor crosses
as its bytes, viewed as uint8, in a copy (:func:`gather_parts`; gloo gathers
no int16) and as f32 in a sum (:func:`sum_over`), so no collective carries a
16-bit float.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

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


def layout(mesh_shape: Sequence[int], world: int) -> np.ndarray:
    """The ranks of a ``mesh_shape`` mesh over ``world`` ranks, laid out as
    the JAX ``make_mesh`` lays out devices: ``-1`` resolved, a prefix of the
    ranks, reshaped row-major."""
    shape = resolve_shape(mesh_shape, world)
    n = int(np.prod(shape))
    if n > world or n < 1:
        raise ValueError(f"mesh {tuple(shape)} over a world of {world}")
    return np.arange(n).reshape(shape)


def axis_lines(ranks: np.ndarray, index: int) -> list:
    """The lines of ``ranks`` along axis ``index``: the rank lists that
    share every other coordinate, in row-major order of those."""
    moved = np.moveaxis(ranks, index, -1)
    return [[int(r) for r in line]
            for line in moved.reshape(-1, ranks.shape[index])]


@dataclass(frozen=True)
class AxisGroup:
    """The ranks of one line of a mesh axis: their process group (``None``
    for the default group), this rank's coordinate on the axis and the
    axis' size."""
    group: Optional[object]
    rank: int
    world: int


DataGroup = AxisGroup  # the ranks a data-parallel step runs over


class Mesh:
    """A mesh of the ranks of the default group (see :func:`make_mesh`):
    ``shape`` {axis: size}, ``ranks`` the layout, and one process group per
    line of each axis (every rank takes part in creating each of them, as
    ``torch.distributed.new_group`` asks)."""

    def __init__(self, mesh_shape: Sequence[int], axis_names: Sequence[str],
                 device_type: str = "cuda"):
        world, rank = dist.get_world_size(), dist.get_rank()
        self.ranks = layout(mesh_shape, world)
        if self.ranks.size != world:
            raise ValueError(f"mesh of {self.ranks.size} ranks over a world "
                             f"of {world}")
        if len(axis_names) != self.ranks.ndim:
            raise ValueError(f"{len(axis_names)} names for a mesh of "
                             f"{self.ranks.ndim} axes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device_type = device_type
        self._axes: Dict[str, AxisGroup] = {}
        for i, name in enumerate(self.axis_names):
            for line in axis_lines(self.ranks, i):
                group = None if len(line) == world else dist.new_group(line)
                if rank in line:
                    self._axes[name] = AxisGroup(group, line.index(rank),
                                                 len(line))

    @classmethod
    def alone(cls, axis_names: Sequence[str],
              device_type: str = "cuda") -> "Mesh":
        """This process as a mesh of one rank (every axis of size 1, no
        process group): the one-process counterpart of a mesh's path, whose
        moves are then copies."""
        mesh = cls.__new__(cls)
        mesh.axis_names = tuple(axis_names)
        mesh.ranks = np.zeros((1,) * len(mesh.axis_names), np.int64)
        mesh.shape = {name: 1 for name in mesh.axis_names}
        mesh.device_type = device_type
        mesh._axes = {name: AxisGroup(None, 0, 1) for name in mesh.axis_names}
        return mesh

    def axis(self, name: str) -> AxisGroup:
        """This rank's line of axis ``name``."""
        return self._axes[name]

    def device_mesh(self, name: str):
        """A one-axis ``DeviceMesh`` of this rank's line of ``name`` (FSDP2's
        mesh): over every rank when the line is the world."""
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

        ax = self.axis(name)
        if ax.group is None:
            return init_device_mesh(self.device_type, (ax.world,),
                                    mesh_dim_names=(name,))
        return DeviceMesh.from_group(ax.group, self.device_type,
                                     mesh_dim_names=(name,))


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda") -> Mesh:
    """A :class:`Mesh` over every rank of the default group (the process
    group must be up), by the JAX ``make_mesh`` rules."""
    return Mesh(mesh_shape, axis_names, device_type)


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


# -------------------------------------------------- the model axes' moves
_NARROW = (torch.bfloat16, torch.float16)


def gather_parts(x: torch.Tensor, ax: AxisGroup) -> List[torch.Tensor]:
    """Every rank's ``x`` on this rank, in rank order (one ``all_gather``;
    a 16-bit float crosses as its bytes, viewed as uint8: gloo gathers no
    int16)."""
    if ax.world == 1:
        return [x]
    src = x.contiguous()
    if x.dtype in _NARROW:
        src = src.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(ax.world)]
    dist.all_gather(parts, src, group=ax.group)
    return [p.view(x.dtype).view(x.shape) for p in parts]


def sum_over(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """``x`` summed over the ranks of ``ax`` (a new tensor; a 16-bit float
    is summed in f32 and rounded back once)."""
    y = x.float() if x.dtype in _NARROW else x.clone()
    if ax.world > 1:
        dist.all_reduce(y, group=ax.group)
    return y.to(x.dtype)


def ppermute_raw(x: torch.Tensor, ax: AxisGroup, shift: int) -> torch.Tensor:
    """Rank r receives rank (r - shift) mod n's ``x`` (every rank calls)."""
    return gather_parts(x, ax)[(ax.rank - shift) % ax.world]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, shift, x):
        ctx.ax, ctx.shift = ax, shift
        return ppermute_raw(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return None, None, ppermute_raw(g, ctx.ax, -ctx.shift)


def ppermute(x: torch.Tensor, ax: AxisGroup, shift: int = 1
             ) -> torch.Tensor:
    """``lax.ppermute`` with the pairs (i, i + shift mod n): rank r gets rank
    r - shift's ``x``; its gradient travels back by the opposite shift."""
    return _PPermute.apply(ax, shift, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(gather_parts(x, ax), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = sum_over(g, ctx.ax)
        return None, None, total.chunk(ctx.ax.world, ctx.dim)[
            ctx.ax.rank].contiguous()


def all_gather(x: torch.Tensor, ax: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``); the gradient of this rank's ``x``
    is its slice of the gradient summed over the ranks."""
    return _AllGather.apply(ax, dim, x)
