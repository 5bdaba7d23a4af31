"""Synthetic dataset: schema-complete, geometrically consistent fake batches
(port of ``hands_tpu/data/synthetic.py``).

Every key of the ``(inputs, targets, meta_info)`` contract is emitted with
consistent geometry: GT MANO parameters are sampled, run through the same
MANO layer the models use, placed with a plausible camera and projected to
2D; crop images get joint blobs so that a model can overfit them.

The numpy draws come in the JAX function's order from the same seed, so both
packages see the same batch. Used by the tests, ``chip_smoke.py`` and
throughput measurements.
"""

from __future__ import annotations

import numpy as np
import torch

from hands_tpu_torch.config import Config
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import mano as manolib


def make_batch(cfg: Config, batch_size: int, seed: int = 0,
               np_arrays: bool = False, device="cuda"):
    """Build one (inputs, targets, meta_info) batch: tensors on ``device``
    (the card unless the caller names the CPU), or numpy arrays with
    ``np_arrays`` (a host pipeline wants those)."""
    B = batch_size
    rng = np.random.RandomState(seed)
    res = cfg.img_res

    # the draws and the MANO pass are host work, as in the JAX function
    mano_r = manolib.load_mano(True)
    mano_l = manolib.load_mano(False)

    K_np = np.zeros((B, 3, 3), np.float32)
    K_np[:, 0, 0] = K_np[:, 1, 1] = cfg.focal_length
    K_np[:, 0, 2] = K_np[:, 1, 2] = res / 2
    K_np[:, 2, 2] = 1.0

    def one_hand(model, x_off):
        pose = rng.randn(B, 48).astype(np.float32) * 0.2
        beta = rng.randn(B, 10).astype(np.float32) * 0.3
        with torch.no_grad():
            out = manolib.mano_forward(
                model, torch.from_numpy(beta), torch.from_numpy(pose[:, 3:]),
                torch.from_numpy(pose[:, :3]))
        joints = out.joints.numpy()
        cam_t = np.stack(
            [
                np.full(B, x_off, np.float32) + rng.randn(B).astype(np.float32) * 0.01,
                rng.randn(B).astype(np.float32) * 0.01,
                np.full(B, 0.6, np.float32) + rng.randn(B).astype(np.float32) * 0.05,
            ],
            axis=-1,
        )
        j3d_full = joints + cam_t[:, None, :]
        proj = np.einsum("bij,bnj->bni", K_np, j3d_full)
        j2d = proj[..., :2] / np.maximum(proj[..., 2:3], 1e-9)
        j2d_norm = 2.0 * j2d / res - 1.0
        j2d_norm3 = np.concatenate(
            [j2d_norm, np.ones_like(j2d_norm[..., :1])], axis=-1)
        return pose, beta, j3d_full, j2d, j2d_norm3

    pose_r, beta_r, j3d_r, j2d_r, j2dn_r = one_hand(mano_r, +0.04)
    pose_l, beta_l, j3d_l, j2d_l, j2dn_l = one_hand(mano_l, -0.04)

    ys, xs = np.mgrid[0:res, 0:res].astype(np.float32)

    def blob_image(j2d):
        """Render joints as gaussian blobs so images carry pose signal."""
        img = rng.rand(B, res, res, 3).astype(np.float32) * 0.1
        for b in range(B):
            for j in range(0, 21, 4):  # subset of joints for speed
                x, y = j2d[b, j]
                if 0 <= x < res and 0 <= y < res:
                    g = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * 9.0))
                    img[b, :, :, j % 3] += g
        return np.clip(img, 0, 1)

    img = blob_image(j2d_r)

    def bbox_angles(j2d):
        lo = j2d.min(axis=1)
        hi = j2d.max(axis=1)
        center = (lo + hi) / 2
        fx = K_np[:, 0, 0]
        cx = K_np[:, 0, 2]
        fy = K_np[:, 1, 1]
        cy = K_np[:, 1, 2]
        center_angle = np.stack(
            [np.arctan2(center[:, 0] - cx, fx), np.arctan2(center[:, 1] - cy, fy)],
            axis=-1,
        ).astype(np.float32)
        corners = np.stack(
            [
                np.stack([lo[:, 0], lo[:, 1]], -1),
                np.stack([lo[:, 0], hi[:, 1]], -1),
                np.stack([hi[:, 0], lo[:, 1]], -1),
                np.stack([hi[:, 0], hi[:, 1]], -1),
            ],
            axis=1,
        )  # (B, 4, 2)
        corner_angle = np.arctan2(
            corners - np.stack([cx, cy], -1)[:, None, :],
            np.stack([fx, fy], -1)[:, None, :],
        ).reshape(B, 8).astype(np.float32)
        bbox = np.concatenate([lo, hi], axis=-1).astype(np.float32)
        return center_angle, corner_angle, bbox

    r_center, r_corner, r_bbox = bbox_angles(j2d_r)
    l_center, l_corner, l_bbox = bbox_angles(j2d_l)

    inputs = XDict({
        "img": img,
        "r_img": blob_image(j2d_r),
        "l_img": blob_image(j2d_l),
        "r_center_angle": r_center,
        "l_center_angle": l_center,
        "r_corner_angle": r_corner,
        "l_corner_angle": l_corner,
        "r_bbox": r_bbox,
        "l_bbox": l_bbox,
    })

    ones = np.ones(B, np.float32)
    zeros = np.zeros(B, np.float32)
    targets = XDict({
        "mano.pose.r": pose_r,
        "mano.pose.l": pose_l,
        "mano.beta.r": beta_r,
        "mano.beta.l": beta_l,
        "mano.j3d.full.r": j3d_r.astype(np.float32),
        "mano.j3d.full.l": j3d_l.astype(np.float32),
        "mano.j2d.norm.r": j2dn_r.astype(np.float32),
        "mano.j2d.norm.l": j2dn_l.astype(np.float32),
        "is_valid": ones,
        "right_valid": ones,
        "left_valid": ones,
        "joints_valid_r": np.ones((B, 21), np.float32),
        "joints_valid_l": np.ones((B, 21), np.float32),
    })
    if cfg.use_grasp_loss:
        targets["grasp.r"] = rng.randint(0, 9, B).astype(np.int32)
        targets["grasp.l"] = rng.randint(0, 9, B).astype(np.int32)
        targets["grasp_valid_r"] = ones
        targets["grasp_valid_l"] = ones
    if cfg.use_render_seg_loss:
        targets["render.r"] = (rng.rand(B, res, res) > 0.8).astype(np.float32)
        targets["render.l"] = (rng.rand(B, res, res) > 0.8).astype(np.float32)
        targets["render_valid_r"] = ones
        targets["render_valid_l"] = ones
    if cfg.use_depth_loss:
        targets["depth.r"] = rng.rand(B, res, res).astype(np.float32)
        targets["depth.l"] = rng.rand(B, res, res).astype(np.float32)
    if cfg.regress_center_corner:
        targets["center.r"] = r_center
        targets["center.l"] = l_center
        targets["corner.r"] = r_corner
        targets["corner.l"] = l_corner

    meta_info = XDict({
        "intrinsics": K_np,
        "is_flipped": zeros,
        "is_j2d_loss": ones,
        "is_j3d_loss": ones,
        "is_pose_loss": ones,
        "is_beta_loss": ones,
        "is_cam_loss": ones,
        "is_grasp_loss": ones if cfg.use_grasp_loss else zeros,
        "is_mask_loss": ones if cfg.use_render_seg_loss else zeros,
        "is_depth_loss": ones if cfg.use_depth_loss else zeros,
    })

    if not np_arrays:
        inputs, targets, meta_info = (to_device(d, device)
                                      for d in (inputs, targets, meta_info))
    return inputs, targets, meta_info


def to_device(d: XDict, device) -> XDict:
    """numpy leaves -> tensors on ``device`` (each array copied once)."""
    return XDict({k: torch.from_numpy(np.array(v)).to(device)
                  for k, v in d.items()})


class SyntheticDataset:
    """Iterable of deterministic synthetic batches (host-side numpy)."""

    def __init__(self, cfg: Config, num_batches: int, batch_size: int,
                 seed: int = 0):
        self.cfg = cfg
        self.num_batches = num_batches
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        for i in range(self.num_batches):
            yield make_batch(self.cfg, self.batch_size,
                             seed=self.seed * 100003 + i, np_arrays=True)
