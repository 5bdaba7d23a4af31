"""Homogeneous and projective geometry (port of
``hands_tpu/core/transforms.py``): homogeneous lifts, 4x4 transforms,
projection, the Arun rigid solve and the 8-coefficient lens distortion of
ARCTIC's egocentric camera.
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


@f32_matmuls
def solve_rigid_tf(A: torch.Tensor, B: torch.Tensor):
    """Least-squares rigid transform (Arun 1987), batched: A, B (B, N, 3)
    corresponding point sets -> (R (B, 3, 3), t (B, 3, 1)) with
    ``R @ A + t ~= B``. A reflection is corrected by flipping the last
    singular vector where det(R) < 0."""
    cA = A.mean(dim=1, keepdim=True)
    cB = B.mean(dim=1, keepdim=True)
    H = torch.einsum("bni,bnj->bij", A - cA, B - cB)  # Am^T @ Bm
    U, _, Vt = torch.linalg.svd(H)
    R = torch.einsum("bji,bkj->bik", Vt, U)  # V @ U^T
    flip = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0)[:, None]
    Vt = torch.cat([Vt[:, :2], Vt[:, 2:] * flip[:, None]], dim=1)
    R = torch.einsum("bji,bkj->bik", Vt, U)
    t = cB.transpose(1, 2) - R @ cA.transpose(1, 2)
    return R, t


@f32_matmuls
def distort_pts3d(pts_cam: torch.Tensor, dist_coeffs) -> torch.Tensor:
    """Undistorted camera-space points -> distorted camera space, so that a
    linear K projection lands on the observed pixels. The 8-coefficient
    rational + tangential model, coeffs = [k1, k2, p1, p2, k3, k4, k5, k6].

    pts_cam: (B, N, 3); dist_coeffs: (8,) or (B, 8). Returns (B, N, 3)."""
    d = torch.as_tensor(dist_coeffs, dtype=pts_cam.dtype,
                        device=pts_cam.device)
    d = d.expand(pts_cam.shape[:1] + (8,))
    z = pts_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    x1 = pts_cam[..., 0] / z_safe
    y1 = pts_cam[..., 1] / z_safe

    x1_2, y1_2, x1y1 = x1 * x1, y1 * y1, x1 * y1
    r2 = x1_2 + y1_2
    r4 = r2 * r2
    r6 = r4 * r2

    dB = d[:, None, :]  # broadcast over points
    r_dist = (1 + dB[..., 0] * r2 + dB[..., 1] * r4 + dB[..., 4] * r6) / (
        1 + dB[..., 5] * r2 + dB[..., 6] * r4 + dB[..., 7] * r6)
    x2 = x1 * r_dist + 2 * dB[..., 2] * x1y1 + dB[..., 3] * (r2 + 2 * x1_2)
    y2 = y1 * r_dist + 2 * dB[..., 3] * x1y1 + dB[..., 2] * (r2 + 2 * y1_2)
    return torch.stack([x2 * z, y2 * z, z], dim=-1)
