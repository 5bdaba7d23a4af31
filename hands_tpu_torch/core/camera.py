"""Camera models (port of ``hands_tpu/core/camera.py``): weak-perspective
<-> perspective, projection, crop intrinsics, the look-at and sphere-pose
helpers, and the closed-form DLT translation solves.

The weak-perspective triple is ``[s, tx, ty]`` with ``s = 2f / (res * tz)``.
Batched, float32, TF32 off where a product is taken.
"""

from __future__ import annotations

import math

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


def unnormalize_kp2d(kp2d_norm: torch.Tensor, img_res: float) -> torch.Tensor:
    """[-1, 1] coords (..., 2) -> pixel coords."""
    return 0.5 * img_res * (kp2d_norm[..., :2] + 1.0)


def weak_perspective_intrinsics(focal_length: float, img_res: int,
                                device="cpu") -> torch.Tensor:
    """Fixed-focal intrinsics centred on the (img_res x img_res) patch."""
    c = img_res // 2
    return torch.tensor(
        [[focal_length, 0.0, c], [0.0, focal_length, c], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device)


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


def get_default_cam_t(focal_length: float, img_res: int,
                      device="cpu") -> torch.Tensor:
    """Camera translation (1, 3) of the canonical weak-perspective camera
    [5, 0, 0]."""
    wp = torch.tensor([[5.0, 0.0, 0.0]], device=device)
    return weak_perspective_to_perspective(
        wp, torch.tensor([focal_length], device=device), img_res)


def get_coord_maps(size: int = 56, device="cpu") -> torch.Tensor:
    """CoordConv-style [-1, 1] xy channel maps, NHWC (1, size, size, 2)."""
    r = torch.linspace(-1.0, 1.0, size, device=device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([xx, yy], dim=-1)[None]


@f32_matmuls
def look_at(eye, at=None, up=None, eps: float = 1e-5) -> torch.Tensor:
    """Camera rotations (B, 3, 3) looking from ``eye`` (B, 3) at ``at``
    (the origin by default); the columns are the camera's x, y, z axes."""
    eye = torch.as_tensor(eye, dtype=torch.float32).reshape(-1, 3)
    dev = eye.device
    at = torch.zeros(3, device=dev) if at is None else torch.as_tensor(
        at, dtype=torch.float32, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev) if up is None else \
        torch.as_tensor(up, dtype=torch.float32, device=dev)

    def norm(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=eps)

    z = norm(eye - at[None])
    x = norm(torch.linalg.cross(up.expand(z.shape), z, dim=-1))
    y = norm(torch.linalg.cross(z, x, dim=-1))
    return torch.stack([x, y, z], dim=-1)


def to_sphere(u, v) -> torch.Tensor:
    """(u, v) in [0, 1]^2 -> a point of the unit sphere (uniform)."""
    theta = 2 * math.pi * u
    phi = torch.arccos(1 - 2 * v)
    return torch.stack([torch.sin(phi) * torch.cos(theta),
                        torch.sin(phi) * torch.sin(theta), torch.cos(phi)],
                       dim=-1)


def sample_pose_on_sphere(generator: torch.Generator, radius: float = 1.0,
                          up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """A random camera pose on a sphere of ``radius`` looking at the
    origin -> (3, 4) [R | t]; (u, v) drawn from ``generator``."""
    dev = generator.device
    u, v = torch.rand(2, generator=generator, device=dev)
    loc = to_sphere(u, v) * radius
    R = look_at(loc[None], up=torch.tensor(up, device=dev))[0]
    return torch.cat([R, loc.reshape(3, 1)], dim=1)


@f32_matmuls
def rectify_pose(camera_r: torch.Tensor, body_aa: torch.Tensor,
                 rotate_x: bool = False) -> torch.Tensor:
    """Compose a camera rotation into axis-angle global orientations."""
    from hands_tpu_torch.core import rot as rotlib

    body_R = rotlib.axis_angle_to_matrix(body_aa.reshape(-1, 3))
    if rotate_x:
        Rx = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                          device=body_R.device)
        body_R = body_R @ Rx
    return rotlib.matrix_to_axis_angle(camera_r @ body_R)


def _dlt_translation(S, joints_2d, joints_conf, fx, fy, center):
    """Weighted normal equations of the DLT translation solve: rows
    [f, 0, -u] and [0, f, -v] against u Z - f X and v Z - f Y, each scaled
    by sqrt(conf). fx, fy (B, N); center (B, 1 or N, 2). Returns (B, 3)."""
    B, N, _ = S.shape
    uv = joints_2d - center
    w = torch.sqrt(torch.clamp(joints_conf, min=0.0))
    zeros = torch.zeros((B, N), dtype=S.dtype, device=S.device)
    A_u = torch.stack([fx, zeros, -uv[..., 0]], dim=-1)
    A_v = torch.stack([zeros, fy, -uv[..., 1]], dim=-1)
    b_u = uv[..., 0] * S[..., 2] - fx * S[..., 0]
    b_v = uv[..., 1] * S[..., 2] - fy * S[..., 1]
    A = torch.cat([A_u * w[..., None], A_v * w[..., None]], dim=1)
    b = torch.cat([b_u * w, b_v * w], dim=1)
    AtA = torch.einsum("bni,bnj->bij", A, A)
    Atb = torch.einsum("bni,bn->bi", A, b)
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    return torch.linalg.solve(AtA + 1e-8 * eye, Atb[..., None])[..., 0]


@f32_matmuls
def estimate_translation(S: torch.Tensor, joints_2d: torch.Tensor,
                         joints_conf: torch.Tensor, focal_length,
                         img_size) -> torch.Tensor:
    """Least-squares camera translation (B, 3) aligning 3D joints S
    (B, N, 3) to 2D detections (B, N, 2) with confidences (B, N), for a
    square image of ``img_size`` and one focal length (scalars or (B,))."""
    B, N, _ = S.shape
    f = torch.as_tensor(focal_length, dtype=torch.float32,
                        device=S.device).expand(B)
    res = torch.as_tensor(img_size, dtype=torch.float32,
                          device=S.device).expand(B)
    fB = f[:, None].expand(B, N)
    return _dlt_translation(S, joints_2d, joints_conf, fB, fB,
                            (res / 2.0)[:, None, None])


@f32_matmuls
def estimate_translation_k(S: torch.Tensor, joints_2d: torch.Tensor,
                           joints_conf: torch.Tensor,
                           K: torch.Tensor) -> torch.Tensor:
    """The DLT translation solve against full intrinsics K (B, 3, 3): the
    focal lengths (fx, fy) and principal point from K."""
    B, N, _ = S.shape
    fx = K[:, 0, 0][:, None].expand(B, N)
    fy = K[:, 1, 1][:, None].expand(B, N)
    center = torch.stack([K[:, 0, 2], K[:, 1, 2]], dim=-1)[:, None, :]
    return _dlt_translation(S, joints_2d, joints_conf, fx, fy, center)
