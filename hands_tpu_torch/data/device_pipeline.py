"""On-device batch preprocessor (port of ``hands_tpu/data/device_pipeline.py``,
eval mode).

The host stacks records into numpy arrays (images stay uint8); the batch
goes to the device once, and everything after that — crop, keypoint and
intrinsics transforms, KPE angles, ImageNet normalisation — runs there in
float32 with TF32 off (the JAX module's float32 matmul pin).

Eval mode draws no augmentation: no flip, no rotation, no box jitter, unit
scale and channel gains. Records that carry a hand mask or a depth map get
their mask and depth targets through a nearest-neighbour crop. Train mode is
ROADMAP queue 1 item 4.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from hands_tpu_torch.config import Config
from hands_tpu_torch.data.records import LOSS_FLAGS, Record
from hands_tpu_torch.core import camera as camlib
from hands_tpu_torch.core.precision import f32_exact
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import preprocess as pp


def stack_records(records: List[Record]) -> dict:
    """Host-side: stack records into one dict of numpy arrays (+ names)."""
    def st(fn):
        return np.stack([np.asarray(fn(r), np.float32) for r in records])

    def det_boxes(fn):
        boxes = [fn(r) for r in records]
        ok = np.asarray([b is not None for b in boxes], np.float32)
        vals = np.stack([
            np.asarray(b, np.float32) if b is not None
            else np.zeros(4, np.float32) for b in boxes])
        return vals, ok

    def st_u8(fn):
        # pixels travel as uint8 (4x less host->device traffic than f32)
        arrs = []
        for r in records:
            a = np.asarray(fn(r))
            if a.dtype != np.uint8:
                a = np.clip(a, 0, 255).astype(np.uint8)
            arrs.append(a)
        return np.stack(arrs)

    r_det, r_ok = det_boxes(lambda r: r.r_bbox)
    l_det, l_ok = det_boxes(lambda r: r.l_bbox)
    out = {
        "image": st_u8(lambda r: r.image),
        "K": st(lambda r: r.K),
        "is_egocam": np.asarray([r.is_egocam for r in records], np.float32),
        # -1 sentinels: fall back to the config-level camera policy
        "use_gt_k": np.asarray(
            [-1.0 if r.use_gt_k is None else float(r.use_gt_k)
             for r in records], np.float32),
        "wp_focal": np.asarray(
            [-1.0 if r.wp_focal is None else float(r.wp_focal)
             for r in records], np.float32),
        "bbox_mode": np.asarray([r.bbox_mode for r in records], np.float32),
        "r_bbox_det": r_det, "r_bbox_ok": r_ok,
        "l_bbox_det": l_det, "l_bbox_ok": l_ok,
        "j2d_r": st(lambda r: r.j2d_r),
        "j2d_l": st(lambda r: r.j2d_l),
        "j3d_r": st(lambda r: r.j3d_r),
        "j3d_l": st(lambda r: r.j3d_l),
        "pose_r": st(lambda r: r.pose_r),
        "pose_l": st(lambda r: r.pose_l),
        "beta_r": st(lambda r: r.beta_r),
        "beta_l": st(lambda r: r.beta_l),
        "bbox": st(lambda r: r.bbox),
        "grasp_r": np.asarray([r.grasp_r for r in records], np.int32),
        "grasp_l": np.asarray([r.grasp_l for r in records], np.int32),
        "right_valid": st(lambda r: r.right_valid),
        "left_valid": st(lambda r: r.left_valid),
        "is_valid": st(lambda r: r.is_valid),
        "joints_valid_r": st(lambda r: r.joints_valid_r),
        "joints_valid_l": st(lambda r: r.joints_valid_l),
        "grasp_valid_r": st(lambda r: r.grasp_valid_r),
        "grasp_valid_l": st(lambda r: r.grasp_valid_l),
        "mask_valid_r": st(lambda r: r.mask_valid_r),
        "mask_valid_l": st(lambda r: r.mask_valid_l),
    }
    for flag in LOSS_FLAGS:
        out[flag] = np.asarray(
            [r.loss_flags.get(flag, 0.0) for r in records], np.float32)
    if records[0].joints3d_valid_r is not None:
        out["joints3d_valid_r"] = st(lambda r: r.joints3d_valid_r)
        out["joints3d_valid_l"] = st(lambda r: r.joints3d_valid_l)
    if records[0].mask is not None:
        out["mask"] = st_u8(lambda r: r.mask)
    if records[0].depth is not None:
        out["depth"] = st(lambda r: r.depth)
    out["_imgnames"] = [r.imgname for r in records]
    out["_dataset"] = [r.dataset for r in records]
    # host-side passthrough (egocam distortion coefficients, NaN if none)
    out["_dist"] = st(lambda r: r.dist)
    return out


class DevicePreprocessor:
    """Record batch -> (inputs, targets, meta_info) on ``device``, eval mode.
    ``device`` is the card unless the caller names the CPU."""

    def __init__(self, cfg: Config, is_train: bool, device="cuda"):
        if is_train:
            raise NotImplementedError(
                "train-mode preprocessing is not ported: ROADMAP queue 1 "
                "item 4")
        if cfg.pos_enc == "pcl":
            raise NotImplementedError(
                "pcl preprocessing (pcl_crop, warp_homography) is not "
                "ported: ROADMAP queue 1 item 4")
        self.cfg = cfg
        self.device = torch.device(device)

    def _process(self, batch: dict):
        cfg = self.cfg
        B = batch["image"].shape[0]
        res = cfg.img_res
        dev = self.device
        augm = pp.augm_params(B, device=dev)
        augm["sc"] = torch.where(batch["is_egocam"] > 0, 1.0, augm["sc"])

        # full-image patch
        center = batch["bbox"][:, :2]
        bbox_dim = batch["bbox"][:, 2]
        img = pp.rgb_crop_augment(batch["image"], center, bbox_dim, augm, res)

        # GT keypoints into (normalised) patch space
        j2d_r = pp.j2d_crop_transform(batch["j2d_r"], center, bbox_dim, augm, res)
        j2d_l = pp.j2d_crop_transform(batch["j2d_l"], center, bbox_dim, augm, res)

        # hand boxes in patch pixel space: tight boxes from the valid GT
        # joints, or the provided boxes mapped through the patch transform
        resm1 = res - 1.0
        full_box = torch.tensor([0.0, 0.0, resm1, resm1], device=dev)

        def joints_tight(j2d_norm, jvalid):
            px = (j2d_norm[..., :2] + 1.0) * 0.5 * resm1  # (B, 21, 2)
            v = (jvalid > 0)[..., None]
            inf = torch.tensor(math.inf, device=dev)
            lo = torch.clamp(torch.amin(torch.where(v, px, inf), dim=1),
                             0, resm1)
            hi = torch.clamp(torch.amax(torch.where(v, px, -inf), dim=1),
                             0, resm1)
            none_valid = ~torch.any(v[:, :, 0], dim=1)
            lo = torch.where(torch.isfinite(lo), lo, 0.0)
            hi = torch.where(torch.isfinite(hi), hi, 0.0)
            xywh = torch.floor(torch.cat([lo, hi - lo], dim=-1))
            degenerate = none_valid | (xywh[:, 2] <= 0) | (xywh[:, 3] <= 0)
            return xywh, degenerate

        def provided_tight(det_xyxy, ok):
            pts = det_xyxy.reshape(B, 2, 2)
            pts = torch.cat([pts, torch.ones((B, 2, 1), device=dev)], dim=-1)
            tp = pp.j2d_crop_transform(pts, center, bbox_dim, augm, res)
            px = torch.clamp((tp[..., :2] + 1.0) * 0.5 * res, 0, resm1)
            xywh = torch.floor(torch.cat([px[:, 0], px[:, 1] - px[:, 0]], -1))
            degenerate = (ok <= 0) | (xywh[:, 2] <= 0) | (xywh[:, 3] <= 0)
            return xywh, degenerate

        mode = batch["bbox_mode"] > 0  # (B,) provided-box records

        def hand_boxes(j2d_norm, jvalid, det, det_ok):
            gt_xywh, gt_degen = joints_tight(j2d_norm, jvalid)
            og = torch.where(gt_degen[:, None], full_box, gt_xywh)
            pr_xywh, pr_degen = provided_tight(det, det_ok)
            pr_og = torch.where(pr_degen[:, None], full_box, pr_xywh)
            xywh = torch.where(mode[:, None], pr_xywh, gt_xywh)
            degen = torch.where(mode, pr_degen, gt_degen)
            og = torch.where(mode[:, None], pr_og, og)
            return xywh, degen, og

        r_xywh, r_full, r_bbox_og = hand_boxes(
            j2d_r, batch["joints_valid_r"], batch["r_bbox_det"],
            batch["r_bbox_ok"])
        l_xywh, l_full, l_bbox_og = hand_boxes(
            j2d_l, batch["joints_valid_l"], batch["l_bbox_det"],
            batch["l_bbox_ok"])

        # square max-side crop geometry (a degenerate box -> full image)
        def crop_geom(xywh, full):
            x0, y0, w, h = (xywh[:, i] for i in range(4))
            xm = torch.floor((2.0 * x0 + w) / 2.0)
            ym = torch.floor((2.0 * y0 + h) / 2.0)
            size = torch.maximum(w, h) * cfg.bbox_scale
            xm = torch.where(full, res / 2.0, xm)
            ym = torch.where(full, res / 2.0, ym)
            size = torch.where(full, float(res), size)
            half = torch.div(size, 2, rounding_mode="floor")
            box = torch.stack([xm - half, ym - half, xm + half, ym + half], -1)
            box = torch.clamp(box, 0, resm1)
            box = torch.where(full[:, None], full_box, box)
            return box, xm, ym, size

        r_bbox, r_cx, r_cy, r_size = crop_geom(r_xywh, r_full)
        l_bbox, l_cx, l_cy, l_size = crop_geom(l_xywh, l_full)

        # intrinsics in patch space: crop-adjusted GT K or weak-persp K
        K_gt = camlib.crop_adjusted_intrinsics(
            batch["K"], center[:, 0], center[:, 1], augm["sc"] * bbox_dim, res)
        wp_f = torch.where(batch["wp_focal"] > 0, batch["wp_focal"],
                           cfg.focal_length)
        c0 = torch.full((B,), float(res // 2), device=dev)
        zeros = torch.zeros((B,), device=dev)
        ones = torch.ones((B,), device=dev)
        K_wp = torch.stack([
            torch.stack([wp_f, zeros, c0], -1),
            torch.stack([zeros, wp_f, c0], -1),
            torch.stack([zeros, zeros, ones], -1),
        ], dim=1)
        use_k = torch.where(batch["use_gt_k"] < 0,
                            1.0 if cfg.use_gt_k else 0.0, batch["use_gt_k"])
        K_patch = torch.where(use_k[:, None, None] > 0, K_gt, K_wp)

        # per-hand crops from the patch
        r_img = torch.clamp(pp.crop_resize_separable(
            img, r_cx, r_cy, r_size, cfg.img_res_ds), 0.0, 1.0)
        l_img = torch.clamp(pp.crop_resize_separable(
            img, l_cx, l_cy, l_size, cfg.img_res_ds), 0.0, 1.0)

        mean, std = cfg.img_norm_mean, cfg.img_norm_std
        inputs = XDict({
            "img": pp.normalize_imagenet(img, mean, std),
            "r_img": pp.normalize_imagenet(r_img, mean, std),
            "l_img": pp.normalize_imagenet(l_img, mean, std),
            "r_bbox": r_bbox,
            "l_bbox": l_bbox,
            "r_bbox_og": r_bbox_og,
            "l_bbox_og": l_bbox_og,
        })
        if cfg.pos_enc is not None:
            for side, box in (("r", r_bbox), ("l", l_bbox)):
                if cfg.pos_enc == "sinusoidal_cc":
                    # normalised crop coordinates, not intrinsics rays
                    center_enc = pp.kpe_center_coords(box, res)
                    corner_enc = pp.kpe_corner_coords(box, res)
                else:
                    center_enc = pp.kpe_center_angles(box, K_patch)
                    corner_enc = pp.kpe_corner_angles(box, K_patch)
                inputs[f"{side}_center_angle"] = center_enc
                inputs[f"{side}_corner_angle"] = corner_enc
                dense = None
                if "cam_conv" in cfg.pos_enc:
                    dense = pp.kpe_camconv_dense(box, K_patch, res)
                elif "dense" in cfg.pos_enc:
                    dense = pp.kpe_dense_angles(box, K_patch, res)
                if dense is not None:
                    inputs[f"{side}_dense_angle"] = dense[0]
                    inputs[f"{side}_dense_mask"] = dense[1]

        # no in-plane rotation in eval: GT 3D joints pass through; the pose
        # still takes the rot_aa round trip, as in the JAX pipeline
        pose_r = pp.pose_aug_rotate(batch["pose_r"], augm["rot"])
        pose_l = pp.pose_aug_rotate(batch["pose_l"], augm["rot"])

        targets = XDict({
            "mano.pose.r": pose_r,
            "mano.pose.l": pose_l,
            "mano.beta.r": batch["beta_r"],
            "mano.beta.l": batch["beta_l"],
            "mano.j3d.full.r": batch["j3d_r"],
            "mano.j3d.full.l": batch["j3d_l"],
            "mano.j2d.norm.r": j2d_r,
            "mano.j2d.norm.l": j2d_l,
            "is_valid": batch["is_valid"],
            "right_valid": batch["right_valid"],
            "left_valid": batch["left_valid"],
            "joints_valid_r": batch["joints_valid_r"],
            "joints_valid_l": batch["joints_valid_l"],
        })
        if cfg.pos_enc is not None:
            targets["center.r"] = inputs["r_center_angle"]
            targets["center.l"] = inputs["l_center_angle"]
            targets["corner.r"] = inputs["r_corner_angle"]
            targets["corner.l"] = inputs["l_corner_angle"]
        if "joints3d_valid_r" in batch:
            targets["joints3d_valid_r"] = batch["joints3d_valid_r"]
            targets["joints3d_valid_l"] = batch["joints3d_valid_l"]
        if cfg.use_grasp_loss:
            targets["grasp.r"] = batch["grasp_r"]
            targets["grasp.l"] = batch["grasp_l"]
            targets["grasp_valid_r"] = batch["grasp_valid_r"]
            targets["grasp_valid_l"] = batch["grasp_valid_l"]
        # records without masks or depth maps: zero targets
        if cfg.use_render_seg_loss:
            if "mask" in batch:
                m = pp.mask_crop(batch["mask"], center, bbox_dim, augm,
                                 res)[..., 0]
                # mask coding: right hand 255, left hand 127
                targets["render.r"] = (torch.abs(m - 255.0) < 32).float()
                targets["render.l"] = (torch.abs(m - 127.0) < 32).float()
            else:
                targets["render.r"] = torch.zeros((B, res, res), device=dev)
                targets["render.l"] = torch.zeros((B, res, res), device=dev)
            targets["render_valid_r"] = batch["mask_valid_r"]
            targets["render_valid_l"] = batch["mask_valid_l"]
        if cfg.use_depth_loss:
            if "depth" in batch:
                d = pp.mask_crop(batch["depth"], center, bbox_dim, augm,
                                 res)[..., 0]
                # per-hand depth: the patch's depth inside the hand's crop box
                xs = torch.arange(res, dtype=torch.float32, device=dev)

                def region(box):
                    in_x = ((xs[None, None, :] >= box[:, 0, None, None])
                            & (xs[None, None, :] < box[:, 2, None, None]))
                    in_y = ((xs[None, :, None] >= box[:, 1, None, None])
                            & (xs[None, :, None] < box[:, 3, None, None]))
                    return (in_x & in_y).to(d.dtype)

                targets["depth.r"] = d * region(r_bbox)
                targets["depth.l"] = d * region(l_bbox)
            else:
                targets["depth.r"] = torch.zeros((B, res, res), device=dev)
                targets["depth.l"] = torch.zeros((B, res, res), device=dev)

        meta_info = XDict({
            "intrinsics": K_patch,
            "is_flipped": augm["flip"],
            "center": center,
            "rot_angle": augm["rot"],
        })
        for flag in LOSS_FLAGS:
            meta_info[flag] = batch[flag]
        return inputs, targets, meta_info

    def __call__(self, record_batch: dict):
        # one host->device copy per array; uint8 pixels widen on the device
        device_batch = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, non_blocking=True)
            for k, v in record_batch.items() if not k.startswith("_")
        }
        with torch.no_grad(), f32_exact():
            inputs, targets, meta_info = self._process(device_batch)
        if "_dist" in record_batch:
            meta_info["dist"] = record_batch["_dist"]
        return inputs, targets, meta_info
