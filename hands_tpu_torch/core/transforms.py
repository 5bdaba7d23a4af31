"""Homogeneous and projective geometry (port of
``hands_tpu/core/transforms.py``, what the forward and the demo use).
Batched, float32, TF32 off where a product is taken."""

from __future__ import annotations

import torch

from hands_tpu_torch.core.precision import f32_matmuls

_EPS = 1e-9


def to_homo(pts: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (..., N, 4) with a trailing 1."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def to_xyz(pts_homo: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) -> (..., N, 3) by the perspective divide on w."""
    return pts_homo[..., :3] / torch.clamp(pts_homo[..., 3:4], min=_EPS)


@f32_matmuls
def transform_points(world2cam: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transforms (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    out = torch.einsum("...ij,...nj->...ni", world2cam, to_homo(pts))
    return to_xyz(out)


@f32_matmuls
def rigid_tf(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Q = R @ p + T, batched: points (B, N, 3), R (B, 3, 3), T (B, 3, 1)."""
    return torch.einsum("bij,bnj->bni", R, points) + T[..., 0][:, None, :]


@f32_matmuls
def project2d(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """K (B, 3, 3), camera-space points (B, N, 3) -> pixels (B, N, 2)."""
    proj = torch.einsum("bij,bnj->bni", K, pts_cam)
    return proj[..., :2] / torch.clamp(proj[..., 2:3], min=_EPS)
