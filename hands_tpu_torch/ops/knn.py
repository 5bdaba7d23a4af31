"""Brute-force batched k nearest neighbours (port of ``hands_tpu/ops/knn.py``).

At hand <-> object scale (778 x ~4k points) the whole pairwise distance
matrix fits on the device, so brute force beats any tree. Ragged point sets
(object meshes padded to one length) take per-batch valid lengths: padded
points get an infinite distance. The JAX package computes this with an
einsum and ``lax.top_k``, outside any Pallas kernel; here it is elementwise
torch ops and ``torch.topk``.

The distance keeps the JAX package's form |q|^2 + |p|^2 - 2 q.p, but its
three-term sums are written out as elementwise float32 operations in a fixed
order, not handed to a GEMM or a reduction, whose order differs between
libraries and devices: the form cancels, so an ulp of |q|^2 (~0.25 m^2 for a
point 0.5 m out) moves a 3 mm distance by micrometres, which moves contacts
across the 3 mm threshold of the contact windows.
"""

from __future__ import annotations

import torch


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a0 b0 + a1 b1 + a2 b2 over the last dim of broadcast operands, in
    that order, one rounding an operation."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def knn(query: torch.Tensor, points: torch.Tensor,
        points_len: torch.Tensor | None = None, k: int = 1):
    """query (B, N, 3), points (B, M, 3), points_len (B,) valid lengths of
    ``points`` -> (dists, idx): L2 distances (B, N, k) and indices (B, N, k)
    of the k nearest points of each query. The distance is the form
    |q|^2 + |p|^2 - 2 q.p, which cancels to about sqrt(eps) * scale."""
    q2 = _dot3(query, query)[:, :, None]  # (B, N, 1)
    p2 = _dot3(points, points)[:, None, :]  # (B, 1, M)
    cross = _dot3(query[:, :, None, :], points[:, None, :, :])  # (B, N, M)
    d2 = q2 + p2 - 2.0 * cross
    if points_len is not None:
        M = points.shape[1]
        mask = torch.arange(M, device=points.device)[None, :] < \
            points_len.to(points.device)[:, None]
        d2 = torch.where(mask[:, None, :], d2,
                         torch.full_like(d2, float("inf")))
    neg_d2, idx = torch.topk(-d2, k, dim=-1)
    return torch.sqrt(torch.clamp(-neg_d2, min=0.0)), idx


def compute_dist_mano_to_obj(mano_v, obj_v, obj_v_len, dist_min, dist_max):
    """Closest-object distance of each MANO vertex, clamped, and the index
    of that object vertex: (B, 778), (B, 778)."""
    d, i = knn(mano_v, obj_v, obj_v_len, k=1)
    return torch.clamp(d[:, :, 0], dist_min, dist_max), i[:, :, 0]


def compute_dist_obj_to_mano(mano_v, obj_v, obj_v_len, dist_min, dist_max):
    """Closest-hand distance of each object vertex (padded ones included,
    as in the JAX package), clamped, and its MANO vertex: (B, M), (B, M)."""
    d, i = knn(obj_v, mano_v, None, k=1)
    return torch.clamp(d[:, :, 0], dist_min, dist_max), i[:, :, 0]


def dist2contact(dist: torch.Tensor, contact_bnd: float) -> torch.Tensor:
    return (dist < contact_bnd).to(torch.int32)
