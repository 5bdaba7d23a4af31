"""Batched on-device preprocessing (port of ``hands_tpu/ops/preprocess.py``,
the eval subset).

Crops are axis-aligned resamples written as two interpolation-weight
products (float32, TF32 off), bilinear for images and nearest-neighbour for
masks and depth maps (``mask_crop``); keypoints, intrinsics and KPE angles
follow the JAX module's math exactly. Train-time augmentation (rotation,
blur, jitter, random draws) and the ``pcl`` resampler (``pcl_crop``,
``warp_homography``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


def augm_params(batch: int, device=None) -> Dict[str, torch.Tensor]:
    """Eval-mode augmentation parameters (none): (B,)-tensors flip, rot
    (deg), sc and (B, 3) channel gains pn. Train-time draws are ROADMAP
    queue 1 item 4."""
    return {
        "flip": torch.zeros(batch, device=device),
        "pn": torch.ones((batch, 3), device=device),
        "rot": torch.zeros(batch, device=device),
        "sc": torch.ones(batch, device=device),
    }


def rgb_crop_augment(images, center, bbox_dim, augm: dict,
                     img_res: int) -> torch.Tensor:
    """Batched ``rgb_processing`` in its eval form (``antialias=False``,
    ``apply_rot=False``: no blur, no rotation pass): square crop of side
    ``sc * bbox_dim * 200`` -> channel gains -> [0, 1] NHWC float."""
    imgs = images.to(torch.float32)
    crop_dim = augm["sc"] * bbox_dim * 200.0
    patch = crop_resize_separable(
        imgs, center[:, 0], center[:, 1], crop_dim, img_res)
    patch = torch.clamp(patch * augm["pn"][:, None, None, :], 0.0, 255.0)
    return patch / 255.0


def mask_crop(masks, center, bbox_dim, augm: dict, img_res: int,
              apply_rot: bool = False) -> torch.Tensor:
    """Batched ``mask_processing``: nearest-neighbour square crop of side
    ``sc * bbox_dim * 200`` of (B, H, W) or (B, H, W, C) masks or depth maps
    -> (B, img_res, img_res, C) float, no blur and no noise. The rotation
    pass of train-time augmentation is not ported (ROADMAP queue 1 item
    4)."""
    if apply_rot:
        raise NotImplementedError(
            "the rotation pass of mask_crop is train-time augmentation: "
            "ROADMAP queue 1 item 4")
    crop_dim = augm["sc"] * bbox_dim * 200.0
    if masks.ndim == 3:
        masks = masks[..., None]
    return crop_resize_separable(masks.to(torch.float32), center[:, 0],
                                 center[:, 1], crop_dim, img_res,
                                 method="nearest")


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

