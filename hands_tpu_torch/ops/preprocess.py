"""Batched on-device preprocessing (port of ``hands_tpu/ops/preprocess.py``).

Crops are axis-aligned resamples written as two interpolation-weight
products (float32, TF32 off), bilinear for images and nearest-neighbour for
masks and depth maps (``mask_crop``); keypoints, intrinsics and KPE angles
follow the JAX module's math exactly.

Train-time augmentation: the draws of :func:`augm_params`, the 5-tap
anti-alias blur, the in-plane rotation of the square patch and the box and
intrinsics jitter. The rotation is one gather pass (:func:`rotate_patch` is
the JAX module's ``rotate_patch_gather``, which that module keeps as the
oracle of its three-shear rotation: a per-pixel gather is what a GPU is good
at, so the shear passes are not ported; the two differ by interpolation
softness only). Every function that draws takes a ``torch.Generator`` and,
instead of it, the raw draws themselves (uniform [0, 1) and standard normal
values), so that a test can feed another framework's.

``pcl`` (perspective crop layers): :func:`pcl_crop` turns a virtual camera
toward each hand's box centre and resamples the patch through the
homography of that camera (:func:`warp_homography`, bilinear, zeros outside
the image). Its 3x3 inverses are closed-form adjugates (:func:`inverse_3x3`)
and its 3x3 products and projections elementwise operations: the same
arithmetic, rounded alike, on every device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.precision import f32_matmuls


def crop_transform(cx, cy, src_size, rot_deg, out_res: int) -> torch.Tensor:
    """Batched dst->src affine maps (B, 2, 3) for square crops: a source
    square of side ``src_size`` centred at (cx, cy), rotated by ``rot_deg``,
    onto the (out_res x out_res) patch."""
    rot_rad = torch.deg2rad(rot_deg)
    cs, sn = torch.cos(rot_rad), torch.sin(rot_rad)
    s = src_size / out_res
    half = out_res / 2.0
    a00 = cs * s
    a01 = -sn * s
    a10 = sn * s
    a11 = cs * s
    tx = cx - (a00 * half + a01 * half)
    ty = cy - (a10 * half + a11 * half)
    return torch.stack(
        [torch.stack([a00, a01, tx], -1), torch.stack([a10, a11, ty], -1)],
        dim=-2)


def _interp_weights(src: torch.Tensor, in_size: int,
                    method: str = "bilinear") -> torch.Tensor:
    """Interpolation weight matrix W (..., out, in): out = W @ signal. Rows
    are the bilinear hat at the fractional source coordinate, or for
    ``"nearest"`` the indicator of the sample within half a pixel;
    coordinates outside [0, in) give zero rows (the gather path's zero
    border)."""
    idx = torch.arange(in_size, dtype=src.dtype, device=src.device)
    d = src[..., None] - idx
    if method == "bilinear":
        return torch.clamp(1.0 - torch.abs(d), min=0.0)
    if method == "nearest":
        return (torch.abs(d) <= 0.5).to(src.dtype)
    raise ValueError(method)


@f32_matmuls
def separable_resample(images: torch.Tensor, y_src: torch.Tensor,
                       x_src: torch.Tensor,
                       method: str = "bilinear") -> torch.Tensor:
    """Axis-aligned resample of (B, H, W, C) as two batched products:
    ``y_src`` (B, outH) and ``x_src`` (B, outW) are source coordinates."""
    Wy = _interp_weights(y_src, images.shape[1], method)  # (B, oh, H)
    Wx = _interp_weights(x_src, images.shape[2], method)  # (B, ow, W)
    tmp = torch.einsum("boh,bhwc->bowc", Wy, images)
    return torch.einsum("bpw,bowc->bopc", Wx, tmp)


def crop_resize_separable(images, cx, cy, src_size, out_res: int,
                          method: str = "bilinear") -> torch.Tensor:
    """Axis-aligned square crop+resize (the rot=0 case of ``crop_transform``)."""
    s = src_size / out_res
    half = out_res / 2.0
    grid = torch.arange(out_res, dtype=torch.float32, device=images.device)
    x_src = s[:, None] * grid[None, :] + (cx - s * half)[:, None]
    y_src = s[:, None] * grid[None, :] + (cy - s * half)[:, None]
    return separable_resample(images, y_src, x_src, method)


def _gather_pixels(flat: torch.Tensor, H: int, W: int, xi: torch.Tensor,
                   yi: torch.Tensor) -> torch.Tensor:
    """Pixels (B, P, C) of ``flat`` (B, H * W, C) at integer coordinates
    (B, P); zeros outside the image (cv2's constant zero border)."""
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[2]))
    return vals * inb[..., None]


def _bilinear_sample(images: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (B, P, C) of (B, H, W, C) at the source coordinates
    (B, P); the taps outside the image count as zeros."""
    B, H, W, C = images.shape
    flat = images.reshape(B, H * W, C)
    # floor before the integer cast: a cast truncates negatives toward 0
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    x0, y0 = x0f.long(), y0f.long()
    fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    top = (_gather_pixels(flat, H, W, x0, y0) * (1 - fx)
           + _gather_pixels(flat, H, W, x0 + 1, y0) * fx)
    bot = (_gather_pixels(flat, H, W, x0, y0 + 1) * (1 - fx)
           + _gather_pixels(flat, H, W, x0 + 1, y0 + 1) * fx)
    return top * (1 - fy) + bot * fy


@f32_matmuls
def warp_affine(images: torch.Tensor, M_inv: torch.Tensor, out_res: int,
                method: str = "bilinear") -> torch.Tensor:
    """Batched inverse-map affine warp of (B, H, W, C) by the dst->src maps
    ``M_inv`` (B, 2, 3) -> (B, out_res, out_res, C): one gather per tap,
    zeros outside the image. ``"bilinear"`` or ``"nearest"`` (the sample
    nearest to the source coordinate, halves to even)."""
    B, H, W, C = images.shape
    grid = torch.arange(out_res, dtype=torch.float32, device=images.device)
    ys, xs = torch.meshgrid(grid, grid, indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    src = torch.einsum("bij,pj->bpi", M_inv, dst)  # (B, P, 2)
    sx, sy = src[..., 0], src[..., 1]
    if method == "nearest":
        out = _gather_pixels(images.reshape(B, H * W, C), H, W,
                             torch.round(sx).long(), torch.round(sy).long())
    elif method == "bilinear":
        out = _bilinear_sample(images, sx, sy)
    else:
        raise ValueError(method)
    return out.reshape(B, out_res, out_res, C)


def rotate_patch(images: torch.Tensor, rot_deg: torch.Tensor,
                 method: str = "bilinear") -> torch.Tensor:
    """Rotate square (B, R, R, C) patches about their centre by ``rot_deg``
    (B,) degrees in one gather pass (``rotate_patch_gather`` of the JAX
    module)."""
    res = images.shape[1]
    half = torch.full_like(rot_deg, res / 2.0)
    M = crop_transform(half, half, torch.full_like(rot_deg, float(res)),
                       rot_deg, res)
    return warp_affine(images, M, res, method=method)


def gaussian_blur(images: torch.Tensor, kernel: int = 5,
                  sigma: float = 8.0) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images with zero padding (the
    anti-alias pass before a train-time crop): each pass is the weighted sum
    of ``kernel`` shifted views, in exact float32."""
    half = kernel // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=images.device)
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    k = k / k.sum()
    H, W = images.shape[1], images.shape[2]
    pad = torch.nn.functional.pad(images, (0, 0, half, half))  # along W
    out = sum(k[i] * pad[:, :, i:i + W] for i in range(kernel))
    pad = torch.nn.functional.pad(out, (0, 0, 0, 0, half, half))  # along H
    return sum(k[i] * pad[:, i:i + H] for i in range(kernel))


def _uniform(shape, generator, device, given=None) -> torch.Tensor:
    if given is not None:
        return torch.as_tensor(given, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, device=device)


def _normal(shape, generator, device, given=None) -> torch.Tensor:
    if given is not None:
        return torch.as_tensor(given, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, device=device)


def augm_params(batch: int, device=None, is_train: bool = False,
                flip_prob: float = 0.0, noise_factor: float = 0.0,
                rot_factor: float = 0.0, scale_factor: float = 0.0,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Batched augmentation parameters: (B,)-tensors flip, rot (deg), sc and
    (B, 3) channel gains pn. Eval mode draws nothing (no flip, no rotation,
    unit scale and gains). Train mode: flip with probability ``flip_prob``;
    gains uniform in 1 +- ``noise_factor``; rotation normal times
    ``rot_factor`` clipped at twice that, and zero with probability 0.6;
    scale normal times ``scale_factor`` + 1 clipped to 1 +- it. ``draws``
    replaces the generator: ``flip_u``, ``rot_u`` (B,) and ``pn_u`` (B, 3)
    uniform in [0, 1), ``rot_n`` and ``sc_n`` (B,) standard normal."""
    if not is_train:
        return {
            "flip": torch.zeros(batch, device=device),
            "pn": torch.ones((batch, 3), device=device),
            "rot": torch.zeros(batch, device=device),
            "sc": torch.ones(batch, device=device),
        }
    d = draws or {}
    flip = (_uniform((batch,), generator, device, d.get("flip_u"))
            <= flip_prob).float()
    lo, hi = 1 - noise_factor, 1 + noise_factor
    pn = torch.clamp(_uniform((batch, 3), generator, device, d.get("pn_u"))
                     * (hi - lo) + lo, min=lo)
    rot = torch.clamp(_normal((batch,), generator, device, d.get("rot_n"))
                      * rot_factor, -2 * rot_factor, 2 * rot_factor)
    rot = torch.where(_uniform((batch,), generator, device, d.get("rot_u"))
                      <= 0.6, 0.0, rot)
    sc = torch.clamp(_normal((batch,), generator, device, d.get("sc_n"))
                     * scale_factor + 1.0, 1 - scale_factor, 1 + scale_factor)
    return {"flip": flip, "pn": pn, "rot": rot, "sc": sc}


def _rot_margin_res(img_res: int) -> int:
    """Smallest even patch side >= img_res * sqrt(2): the central img_res
    window of a rotation of this patch never touches the zero corners."""
    big = int(np.ceil(img_res * np.sqrt(2.0)))
    return big + (big - img_res) % 2


def _crop_maybe_rotated(imgs, center, crop_dim, rot, img_res: int,
                        method: str, apply_rot: bool) -> torch.Tensor:
    if not apply_rot:
        return crop_resize_separable(imgs, center[:, 0], center[:, 1],
                                     crop_dim, img_res, method=method)
    # sqrt(2) margin: the rotated square samples image content at its
    # corners instead of the zero wedge of a tight crop-then-rotate
    big = _rot_margin_res(img_res)
    patch = crop_resize_separable(imgs, center[:, 0], center[:, 1],
                                  crop_dim * (big / img_res), big,
                                  method=method)
    patch = rotate_patch(patch, rot, method=method)
    off = (big - img_res) // 2
    return patch[:, off:off + img_res, off:off + img_res, :]


def rgb_crop_augment(images, center, bbox_dim, augm: dict, img_res: int,
                     antialias: bool = False, method: str = "bilinear",
                     apply_rot: bool = False) -> torch.Tensor:
    """Batched ``rgb_processing``: blur (``antialias``) -> square crop of
    side ``sc * bbox_dim * 200``, rotated by ``augm["rot"]`` with
    ``apply_rot`` -> channel gains -> [0, 1] NHWC float. Eval pipelines leave
    both switches off: no blur, no rotation pass."""
    imgs = images.to(torch.float32)
    if antialias:
        imgs = gaussian_blur(imgs)
    crop_dim = augm["sc"] * bbox_dim * 200.0
    patch = _crop_maybe_rotated(imgs, center, crop_dim, augm["rot"], img_res,
                                method, apply_rot)
    patch = torch.clamp(patch * augm["pn"][:, None, None, :], 0.0, 255.0)
    return patch / 255.0


def mask_crop(masks, center, bbox_dim, augm: dict, img_res: int,
              apply_rot: bool = False) -> torch.Tensor:
    """Batched ``mask_processing``: nearest-neighbour square crop of side
    ``sc * bbox_dim * 200`` of (B, H, W) or (B, H, W, C) masks or depth maps
    -> (B, img_res, img_res, C) float, no blur and no noise; rotated by
    ``augm["rot"]`` with ``apply_rot``."""
    crop_dim = augm["sc"] * bbox_dim * 200.0
    if masks.ndim == 3:
        masks = masks[..., None]
    return _crop_maybe_rotated(masks.to(torch.float32), center, crop_dim,
                               augm["rot"], img_res, "nearest", apply_rot)


def jitter_bbox(bbox: torch.Tensor, t_stdev: float = 0.2,
                generator: Optional[torch.Generator] = None,
                draws=None) -> torch.Tensor:
    """Translation-only jitter of (B, 4) [x0, y0, w, h] boxes: the centre
    moves by uniform(-1, 1) * ``t_stdev`` of the box's size. ``draws``: (B, 2)
    uniform in [0, 1)."""
    wh = bbox[:, 2:]
    center = bbox[:, :2] + wh / 2
    u = _uniform((bbox.shape[0], 2), generator, bbox.device, draws)
    new_center = center + (u * 2 - 1) * t_stdev * wh
    return torch.cat([new_center - wh / 2, wh], dim=-1)


def jitter_intrinsics(K: torch.Tensor, s_stdev: float = 0.5,
                      t_stdev: float = 0.2,
                      generator: Optional[torch.Generator] = None,
                      draws=None) -> torch.Tensor:
    """Batched intrinsics jitter of (B, 3, 3): focal lengths times
    exp(uniform(-s, s)), principal point times 1 + uniform(-t, t). ``draws``:
    ((B,), (B, 2)) uniform in [0, 1)."""
    B = K.shape[0]
    us, ut = draws if draws is not None else (None, None)
    jitter_s = torch.exp(_uniform((B,), generator, K.device, us)
                         * s_stdev * 2 - s_stdev)
    jitter_t = (_uniform((B, 2), generator, K.device, ut) * t_stdev * 2
                - t_stdev)
    K = K.clone()
    K[:, 0, 0] *= jitter_s
    K[:, 1, 1] *= jitter_s
    K[:, 0, 2] *= 1.0 + jitter_t[:, 0]
    K[:, 1, 2] *= 1.0 + jitter_t[:, 1]
    return K


@f32_matmuls
def j2d_crop_transform(kp2d, center, bbox_dim, augm: dict,
                       img_res: int) -> torch.Tensor:
    """Batched ``j2d_processing``: keypoints (B, J, 2+) through the crop+rot
    transform, normalised to [-1, 1]."""
    crop_dim = augm["sc"] * bbox_dim * 200.0
    M = crop_transform(center[:, 0], center[:, 1], crop_dim, augm["rot"],
                       img_res)
    A = M[:, :, :2]
    t = M[:, :, 2]
    A_inv = torch.linalg.inv(A)
    xy = torch.einsum("bij,bnj->bni", A_inv, kp2d[..., :2] - t[:, None, :])
    xy_norm = 2.0 * xy / img_res - 1.0
    return torch.cat([xy_norm, kp2d[..., 2:]], dim=-1)


def inverse_3x3(M: torch.Tensor) -> torch.Tensor:
    """Inverses of (B, 3, 3) matrices as adjugate / determinant: a fixed
    sequence of f32 operations, where ``torch.linalg.inv`` would call a
    batched solver."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    c00, c01, c02 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * c00 + b * c01 + c * c02
    adj = torch.stack([
        c00, c * h - b * i, b * f - c * e,
        c01, a * i - c * g, c * d - a * f,
        c02, b * g - a * h, a * e - b * d], dim=-1).reshape(-1, 3, 3)
    return adj / det[:, None, None]


def _matmul_3x3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A (N, 3, 3) @ B (N, 3, k) as (a0 b0 + a1 b1) + a2 b2: elementwise
    operations, rounded alike on every device (a library product sums in its
    own order)."""
    a0, a1, a2 = (A[:, :, j, None] for j in range(3))
    return (a0 * B[:, None, 0] + a1 * B[:, None, 1]) + a2 * B[:, None, 2]


def _pcl_rotation_from_position(pos: torch.Tensor) -> torch.Tensor:
    """Virtual-camera rotation R_virt2orig (B, 3, 3) looking along the rays
    ``pos`` (B, 3) (normalised directions, z = 1)."""
    x, y = pos[:, 0], pos[:, 1]
    n1x = torch.sqrt(1 + x * x)
    d1x = 1.0 / n1x
    d1xy = 1.0 / torch.sqrt(1 + x * x + y * y)
    d1xy1x = 1.0 / torch.sqrt((1 + x * x + y * y) * (1 + x * x))
    zeros = torch.zeros_like(x)
    R = torch.stack(
        [d1x, -x * y * d1xy1x, x * d1xy,
         zeros, n1x * d1xy, y * d1xy,
         -x * d1x, -y * d1xy1x, d1xy], dim=-1)
    return R.reshape(-1, 3, 3)


def _pcl_virtual_intrinsics(pos: torch.Tensor, K: torch.Tensor,
                            bbox_wh: torch.Tensor) -> torch.Tensor:
    """Virtual camera K (B, 3, 3): the focal at the image plane with the slant
    compensated, in unit [0, 1] image coordinates."""
    p_len = torch.sqrt(torch.sum(pos * pos, dim=-1))
    sx = 1.0 / torch.sqrt(pos[:, 0] ** 2 + pos[:, 2] ** 2)
    sy = torch.sqrt(pos[:, 0] ** 2 + 1) / torch.sqrt(
        pos[:, 0] ** 2 + pos[:, 1] ** 2 + 1)
    bbox_comp = bbox_wh * torch.stack([sx, sy], -1)
    f_orig = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)
    f_comp = p_len[:, None] * f_orig / torch.clamp(bbox_comp, min=1e-6)
    Kv = torch.zeros((pos.shape[0], 3, 3), dtype=pos.dtype,
                     device=pos.device)
    Kv[:, 0, 0] = f_comp[:, 0]
    Kv[:, 1, 1] = f_comp[:, 1]
    Kv[:, 0, 2] = 0.5
    Kv[:, 1, 2] = 0.5
    Kv[:, 2, 2] = 1.0
    return Kv


def _unit_grid(n: int, device) -> torch.Tensor:
    """``n`` points from 0 to 1 as jitted ``jnp.linspace`` makes them: i times
    the f32 reciprocal of n - 1, then 1 exactly (``torch.linspace`` steps
    from both ends and differs at interior points)."""
    step = float(np.float32(1.0) / np.float32(max(n - 1, 1)))
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    if n > 1:
        t[-1] = 1.0
    return t


def homography_coords(P: torch.Tensor, out_res: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The texel coordinates (sx, sy), each (B, out_res^2) in row-major
    order, that :func:`warp_homography` samples through ``P`` (B, 3, 3)."""
    t = _unit_grid(out_res, P.device)
    vs, us = torch.meshgrid(t, t, indexing="ij")
    us, vs = us.reshape(1, -1), vs.reshape(1, -1)
    # P @ [u, v, 1] as (P0 u + P1 v) + P2: elementwise operations, rounded
    # alike on every device
    x, y, z = ((P[:, i, 0, None] * us + P[:, i, 1, None] * vs)
               + P[:, i, 2, None] for i in range(3))
    # the homogeneous divide keeps the sign of z and clamps its size
    sign = torch.sign(z + 1e-12)
    den = torch.clamp(torch.abs(z), min=1e-8)
    return x / den * sign - 0.5, y / den * sign - 0.5


def warp_homography(images: torch.Tensor, P: torch.Tensor,
                    out_res: int) -> torch.Tensor:
    """Sample (B, H, W, C) images through projective maps ``P`` (B, 3, 3),
    ``src = P @ [u, v, 1]`` for unit coordinates u, v in [0, 1]: bilinear,
    zeros outside the image -> (B, out_res, out_res, C). A projected pixel
    coordinate p samples texel p - 0.5 (``grid_sample``'s pixel-edge
    convention, ``align_corners=False``)."""
    B, _, _, C = images.shape
    sx, sy = homography_coords(P, out_res)
    return _bilinear_sample(images, sx, sy).reshape(B, out_res, out_res, C)


def pcl_crop(images: torch.Tensor, bbox_xyxy: torch.Tensor, K: torch.Tensor,
             out_res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective-crop-layer resample of the patch ``images`` (B, H, W, C)
    in [0, 1] at the hand boxes ``bbox_xyxy`` (B, 4) with the patch
    intrinsics ``K`` (B, 3, 3): a virtual camera turned toward the box
    centre's ray, the homography ``K @ R_virt2orig @ inv(K_virt)``, then
    :func:`warp_homography`. Returns (crops (B, out_res, out_res, C),
    R_virt2orig (B, 3, 3)); the model rotates its predicted global
    orientation by R."""
    center = (bbox_xyxy[:, :2] + bbox_xyxy[:, 2:]) / 2.0
    wh = torch.clamp(bbox_xyxy[:, 2:] - bbox_xyxy[:, :2], min=1.0)
    size = torch.maximum(wh[:, 0], wh[:, 1])
    bbox_wh = torch.stack([size, size], -1)
    homo = torch.cat([center, torch.ones_like(center[:, :1])], -1)
    pos = _matmul_3x3(inverse_3x3(K), homo[:, :, None])[:, :, 0]
    R = _pcl_rotation_from_position(pos)
    Kv = _pcl_virtual_intrinsics(pos, K, bbox_wh)
    P = _matmul_3x3(_matmul_3x3(K, R), inverse_3x3(Kv))
    return warp_homography(images, P, out_res), R


def pose_aug_rotate(pose: torch.Tensor, rot_deg: torch.Tensor) -> torch.Tensor:
    """Rotate the global-orient entry of flattened MANO poses (B, 48)."""
    glob = rotlib.rot_aa(pose[:, :3], rot_deg)
    return torch.cat([glob, pose[:, 3:]], dim=-1)


def kpe_center_angles(bbox_xyxy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, 2) ray angles of the crop centre: arctan2(c - pp, f)."""
    center = (bbox_xyxy[:, :2] + bbox_xyxy[:, 2:]) / 2.0
    ax = torch.atan2(center[:, 0] - K[:, 0, 2], K[:, 0, 0])
    ay = torch.atan2(center[:, 1] - K[:, 1, 2], K[:, 1, 1])
    return torch.stack([ax, ay], dim=-1)


def kpe_corner_angles(bbox_xyxy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, 8) ray angles of the 4 crop corners, corner-major [x, y] pairs."""
    x0, y0, x1, y1 = (bbox_xyxy[:, i] for i in range(4))
    corners = torch.stack(
        [
            torch.stack([x0, y0], -1), torch.stack([x0, y1], -1),
            torch.stack([x1, y0], -1), torch.stack([x1, y1], -1),
        ],
        dim=1,
    )  # (B, 4, 2)
    pp = torch.stack([K[:, 0, 2], K[:, 1, 2]], -1)[:, None, :]
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None, :]
    return torch.atan2(corners - pp, f).reshape(-1, 8)


def _crop_lattice(bbox_xyxy: torch.Tensor, img_res: int):
    """A fixed (img_res x img_res) lattice across each box: x (B, W) and
    y (B, H) sample coordinates (static shapes, mask all ones)."""
    t = torch.linspace(0.0, 1.0, img_res, device=bbox_xyxy.device)
    x0, y0, x1, y1 = (bbox_xyxy[:, i] for i in range(4))
    gx = x0[:, None] + (x1 - x0)[:, None] * t[None, :]
    gy = y0[:, None] + (y1 - y0)[:, None] * t[None, :]
    return gx, gy


def kpe_dense_angles(bbox_xyxy: torch.Tensor, K: torch.Tensor,
                     img_res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-pixel ray angles over each crop: angles (B, H, W, 2) NHWC
    and a validity mask (B, H, W) of ones."""
    B = bbox_xyxy.shape[0]
    gx, gy = _crop_lattice(bbox_xyxy, img_res)
    ax = torch.atan2(gx[:, None, :] - K[:, 0, 2, None, None],
                     K[:, 0, 0, None, None])
    ay = torch.atan2(gy[:, :, None] - K[:, 1, 2, None, None],
                     K[:, 1, 1, None, None])
    angles = torch.stack([ax.expand(B, img_res, img_res),
                          ay.expand(B, img_res, img_res)], dim=-1)
    return angles, torch.ones((B, img_res, img_res), device=bbox_xyxy.device)


def kpe_center_coords(bbox_xyxy: torch.Tensor, img_res: int) -> torch.Tensor:
    """``sinusoidal_cc`` centre "angles": normalised crop coordinates
    ``2 c / img_res - 1``."""
    center = (bbox_xyxy[:, :2] + bbox_xyxy[:, 2:]) / 2.0
    return 2.0 * center / img_res - 1.0


def kpe_corner_coords(bbox_xyxy: torch.Tensor, img_res: int) -> torch.Tensor:
    """``sinusoidal_cc`` corner "angles": (B, 8) normalised crop
    coordinates, corner-major [x, y] pairs."""
    x0, y0, x1, y1 = (bbox_xyxy[:, i] for i in range(4))
    corners = torch.stack(
        [
            torch.stack([x0, y0], -1), torch.stack([x0, y1], -1),
            torch.stack([x1, y0], -1), torch.stack([x1, y1], -1),
        ],
        dim=1,
    )  # (B, 4, 2)
    return (2.0 * corners / img_res - 1.0).reshape(-1, 8)


def kpe_camconv_dense(bbox_xyxy: torch.Tensor, K: torch.Tensor,
                      img_res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cam_conv`` 6-channel dense encoding: per pixel [ray angle x/y, pixel
    offset from the principal point x/y, centred coordinate x/y], on the
    lattice of :func:`kpe_dense_angles`: (B, H, W, 6) NHWC and a mask of
    ones (B, H, W)."""
    B = bbox_xyxy.shape[0]
    gx, gy = _crop_lattice(bbox_xyxy, img_res)
    gx = gx[:, None, :].expand(B, img_res, img_res)
    gy = gy[:, :, None].expand(B, img_res, img_res)
    dx = gx - K[:, 0, 2, None, None]
    dy = gy - K[:, 1, 2, None, None]
    ax = torch.atan2(dx, K[:, 0, 0, None, None])
    ay = torch.atan2(dy, K[:, 1, 1, None, None])
    cxn = 2.0 * gx / img_res - 1.0
    cyn = 2.0 * gy / img_res - 1.0
    enc = torch.stack([ax, ay, dx, dy, cxn, cyn], dim=-1)
    return enc, torch.ones((B, img_res, img_res), device=bbox_xyxy.device)


def normalize_imagenet(images: torch.Tensor, mean, std) -> torch.Tensor:
    """[0,1] NHWC -> ImageNet-normalised."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std

