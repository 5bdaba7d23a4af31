"""Camera models (port of ``hands_tpu/core/camera.py``, the subset serving
and the train step use).

The weak-perspective triple is ``[s, tx, ty]`` with ``s = 2f / (res * tz)``.
Batched, float32, TF32 off where a product is taken.
"""

from __future__ import annotations

import torch

from hands_tpu_torch.core.precision import f32_matmuls

_EPS = 1e-9


def perspective_to_weak_perspective(
    cam_t: torch.Tensor, focal_length: torch.Tensor, img_res: float
) -> torch.Tensor:
    """Camera translation (B, 3) [tx, ty, tz] -> weak-persp (B, 3) [s, tx, ty]."""
    tx, ty, tz = cam_t[:, 0], cam_t[:, 1], cam_t[:, 2]
    s = 2.0 * focal_length / (img_res * tz + _EPS)
    return torch.stack([s, tx, ty], dim=-1)


def weak_perspective_to_perspective(
    wp_cam: torch.Tensor,
    focal_length: torch.Tensor,
    img_res: float,
    min_s: float = 0.1,
) -> torch.Tensor:
    """Weak-persp (B, 3) [s, tx, ty] -> camera translation (B, 3) [tx, ty, tz];
    ``min_s`` clamps the scale so tz stays finite and positive."""
    s = torch.clamp(wp_cam[:, 0], min=min_s)
    tz = 2.0 * focal_length / (img_res * s + _EPS)
    return torch.stack([wp_cam[:, 1], wp_cam[:, 2], tz], dim=-1)


@f32_matmuls
def project2d(K: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Perspective projection: K (B, 3, 3) x points (B, N, 3) -> pixels (B, N, 2)."""
    proj = torch.einsum("bij,bnj->bni", K, pts3d)
    return proj[..., :2] / torch.clamp(proj[..., 2:3], min=_EPS)


def normalize_kp2d(kp2d: torch.Tensor, img_res: float) -> torch.Tensor:
    """Pixel coords (..., 2+) -> [-1, 1] on the first two channels."""
    xy = 2.0 * kp2d[..., :2] / img_res - 1.0
    return torch.cat([xy, kp2d[..., 2:]], dim=-1)


def crop_adjusted_intrinsics(
    K: torch.Tensor,
    bbox_cx: torch.Tensor,
    bbox_cy: torch.Tensor,
    scale: torch.Tensor,
    img_res: int,
) -> torch.Tensor:
    """Full-image intrinsics (B, 3, 3) -> intrinsics of a square crop of side
    ``scale * 200`` centred at (bbox_cx, bbox_cy), resized to img_res."""
    dim = scale * 200.0
    k_scale = img_res / dim
    fx = K[:, 0, 0] * k_scale
    fy = K[:, 1, 1] * k_scale
    cx = (K[:, 0, 2] - (bbox_cx - dim / 2.0)) * k_scale
    cy = (K[:, 1, 2] - (bbox_cy - dim / 2.0)) * k_scale
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([fx, zeros, cx], dim=-1)
    row1 = torch.stack([zeros, fy, cy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
