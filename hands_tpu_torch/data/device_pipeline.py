"""On-device batch preprocessor and the loaders around it (port of
``hands_tpu/data/device_pipeline.py``).

The host stacks records into numpy arrays (images stay uint8); the batch
goes to the device once, and everything after that — crop, keypoint and
intrinsics transforms, KPE angles, ImageNet normalisation — runs there in
float32 with TF32 off (the JAX module's float32 matmul pin).

Eval mode draws no augmentation: no flip, no rotation, no box jitter, unit
scale and channel gains. Train mode draws flip, rotation, scale and channel
gains per image, blurs before the crop, rotates the patch (and the mask and
depth targets, the GT 3D joints and the global orientation with it), jitters
the hand boxes and mirrors flipped images with their boxes. Records that carry
a hand mask or a depth map get their mask and depth targets through a
nearest-neighbour crop. With ``pos_enc == "pcl"`` the hand crops are the
perspective crops of ``ops.preprocess.pcl_crop`` (a virtual camera turned
toward each hand), and ``inputs`` carries their rotations as ``r_rot`` and
``l_rot``.

:class:`DeviceDataLoader` turns a dataset of records, or a packed dataset
that hands out whole stacked batches (``data/packed.py``), into a stream of
such batches; :class:`PrefetchLoader` runs its host half (fetch, stacking,
pinning) on a background thread.
"""

from __future__ import annotations

import copy
import math
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from hands_tpu_torch.config import Config
from hands_tpu_torch.data.records import LOSS_FLAGS, Record
from hands_tpu_torch.core import camera as camlib
from hands_tpu_torch.core.precision import f32_exact
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import preprocess as pp


def stack_records(records: List[Record]) -> dict:
    """Host-side: stack records into one dict of numpy arrays (+ names).

    A batch of an ``a+b+c`` mix may hold images of several sizes, and masks,
    depth maps or per-joint 3D validity on some records only. Images, masks
    and depth maps are then zero-padded at the bottom and right to the
    largest height and width (K and the boxes keep their pixels), a record
    without a mask or depth map gets zeros (its ``mask_valid`` is 0 and its
    loss flag off), and one without per-joint 3D validity gets ones. The
    JAX package stacks only batches of one size and of the first record's
    fields."""
    def st(fn):
        return np.stack([np.asarray(fn(r), np.float32) for r in records])

    max_h = max(r.image.shape[0] for r in records)
    max_w = max(r.image.shape[1] for r in records)

    def padded(a, dtype):
        a = np.asarray(a, dtype)
        if a.shape[:2] == (max_h, max_w):
            return a
        out = np.zeros((max_h, max_w) + a.shape[2:], dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    def st_maps(fn, dtype):
        """Per-pixel maps (masks, depth) at the image size; zeros where a
        record has none."""
        return np.stack([np.zeros((max_h, max_w), dtype) if fn(r) is None
                         else padded(fn(r), dtype) for r in records])

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
            arrs.append(padded(a, np.uint8))
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
    if any(r.joints3d_valid_r is not None for r in records):
        ones = np.ones(21, np.float32)
        for side in ("r", "l"):
            out[f"joints3d_valid_{side}"] = st(
                lambda r: ones if getattr(r, f"joints3d_valid_{side}") is None
                else getattr(r, f"joints3d_valid_{side}"))
    if any(r.mask is not None for r in records):
        out["mask"] = st_maps(
            lambda r: None if r.mask is None
            else np.clip(np.asarray(r.mask), 0, 255).astype(np.uint8),
            np.uint8)
    if any(r.depth is not None for r in records):
        out["depth"] = st_maps(lambda r: r.depth, np.float32)
    out["_imgnames"] = [r.imgname for r in records]
    out["_dataset"] = [r.dataset for r in records]
    # host-side passthrough (egocam distortion coefficients, NaN if none)
    out["_dist"] = st(lambda r: r.dist)
    return out


class DevicePreprocessor:
    """Record batch -> (inputs, targets, meta_info) on ``device``, in eval or
    train mode. ``device`` is the card unless the caller names the CPU.

    Train mode draws its augmentation from the ``generator`` given to the
    call (a ``torch.Generator`` on ``device``), in this order: flip, channel
    gains, rotation (normal, then the keep-or-zero uniform), scale, the right
    hand's box jitter, the left hand's. ``draws`` replaces the generator:
    ``{"augm": the dict of ops.preprocess.augm_params, "jitter_r": (B, 2),
    "jitter_l": (B, 2)}`` of raw uniform and normal values."""

    def __init__(self, cfg: Config, is_train: bool, device="cuda"):
        self.cfg = cfg
        self.is_train = is_train
        self.device = torch.device(device)

    def _process(self, batch: dict, generator=None, draws=None):
        cfg = self.cfg
        B = batch["image"].shape[0]
        res = cfg.img_res
        dev = self.device
        draws = draws or {}
        augm = pp.augm_params(
            B, dev, self.is_train, cfg.flip_prob, cfg.noise_factor,
            cfg.rot_factor, cfg.scale_factor, generator, draws.get("augm"))
        # no scaling for egocam records: their intrinsics stay consistent
        augm["sc"] = torch.where(batch["is_egocam"] > 0, 1.0, augm["sc"])

        # full-image patch: blur -> (rotated) crop -> channel gains
        center = batch["bbox"][:, :2]
        bbox_dim = batch["bbox"][:, 2]
        img = pp.rgb_crop_augment(
            batch["image"], center, bbox_dim, augm, res,
            antialias=self.is_train, apply_rot=self.is_train)

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

        def jitter_recheck(xywh, degen, side):
            # train mode: jitter the tight box, clip it, check it again
            if not self.is_train:
                return xywh, degen
            j = torch.floor(pp.jitter_bbox(
                xywh, generator=generator, draws=draws.get(f"jitter_{side}")))
            x0 = torch.clamp(j[:, 0], 0, resm1)
            y0 = torch.clamp(j[:, 1], 0, resm1)
            x1 = torch.clamp(j[:, 0] + j[:, 2], 0, resm1)
            y1 = torch.clamp(j[:, 1] + j[:, 3], 0, resm1)
            new = torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)
            return new, degen | (new[:, 2] <= 0) | (new[:, 3] <= 0)

        mode = batch["bbox_mode"] > 0  # (B,) provided-box records

        def hand_boxes(j2d_norm, jvalid, det, det_ok, side):
            gt_xywh, gt_degen = joints_tight(j2d_norm, jvalid)
            og = torch.where(gt_degen[:, None], full_box, gt_xywh)
            gt_xywh, gt_degen = jitter_recheck(gt_xywh, gt_degen, side)
            pr_xywh, pr_degen = provided_tight(det, det_ok)
            pr_og = torch.where(pr_degen[:, None], full_box, pr_xywh)
            xywh = torch.where(mode[:, None], pr_xywh, gt_xywh)
            degen = torch.where(mode, pr_degen, gt_degen)
            og = torch.where(mode[:, None], pr_og, og)
            return xywh, degen, og

        r_xywh, r_full, r_bbox_og = hand_boxes(
            j2d_r, batch["joints_valid_r"], batch["r_bbox_det"],
            batch["r_bbox_ok"], "r")
        l_xywh, l_full, l_bbox_og = hand_boxes(
            j2d_l, batch["joints_valid_l"], batch["l_bbox_det"],
            batch["l_bbox_ok"], "l")

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

        # per-hand crops from the patch: a perspective crop through a
        # virtual camera turned toward the hand (pcl), else axis-aligned
        rots = {}
        if cfg.pos_enc == "pcl":
            r_img, rots["r_rot"] = pp.pcl_crop(img, r_bbox, K_patch,
                                               cfg.img_res_ds)
            l_img, rots["l_rot"] = pp.pcl_crop(img, l_bbox, K_patch,
                                               cfg.img_res_ds)
        else:
            r_img = torch.clamp(pp.crop_resize_separable(
                img, r_cx, r_cy, r_size, cfg.img_res_ds), 0.0, 1.0)
            l_img = torch.clamp(pp.crop_resize_separable(
                img, l_cx, l_cy, l_size, cfg.img_res_ds), 0.0, 1.0)

        # horizontal flip: pixels mirror; boxes mirror and swap sides (the
        # model's flip-swap un-mirrors the predictions); GT targets stay
        r_bbox_noflip, l_bbox_noflip = r_bbox, l_bbox
        if self.is_train:
            flip = augm["flip"].reshape(B, 1, 1, 1) > 0
            img, r_img, l_img = (torch.where(flip, t.flip(2), t)
                                 for t in (img, r_img, l_img))

            def mirror_bbox(bb):
                x0, y0, x1, y1 = (bb[:, i] for i in range(4))
                return torch.stack([res - 1 - x1, y0, res - 1 - x0, y1], -1)

            fb = augm["flip"].reshape(B, 1) > 0
            r_bbox, l_bbox = (torch.where(fb, mirror_bbox(l_bbox), r_bbox),
                              torch.where(fb, mirror_bbox(r_bbox), l_bbox))

        mean, std = cfg.img_norm_mean, cfg.img_norm_std
        inputs = XDict({
            "img": pp.normalize_imagenet(img, mean, std),
            "r_img": pp.normalize_imagenet(r_img, mean, std),
            "l_img": pp.normalize_imagenet(l_img, mean, std),
            "r_bbox": r_bbox,
            "l_bbox": l_bbox,
            "r_bbox_og": r_bbox_og,
            "l_bbox_og": l_bbox_og,
            **rots,
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

        # the in-plane rotation turns the global orientation and the GT 3D
        # joints with the patch (eval: zero rotation, joints pass through;
        # the pose still takes the rot_aa round trip, as in the JAX pipeline)
        pose_r = pp.pose_aug_rotate(batch["pose_r"], augm["rot"])
        pose_l = pp.pose_aug_rotate(batch["pose_l"], augm["rot"])
        j3d_r, j3d_l = batch["j3d_r"], batch["j3d_l"]
        if self.is_train:
            rad = -augm["rot"] * math.pi / 180.0
            c, sn = torch.cos(rad), torch.sin(rad)
            zero, one = torch.zeros_like(c), torch.ones_like(c)
            Rz = torch.stack([c, -sn, zero, sn, c, zero, zero, zero, one],
                             -1).reshape(B, 3, 3)
            j3d_r = torch.einsum("bij,bnj->bni", Rz, j3d_r)
            j3d_l = torch.einsum("bij,bnj->bni", Rz, j3d_l)

        targets = XDict({
            "mano.pose.r": pose_r,
            "mano.pose.l": pose_l,
            "mano.beta.r": batch["beta_r"],
            "mano.beta.l": batch["beta_l"],
            "mano.j3d.full.r": j3d_r,
            "mano.j3d.full.l": j3d_l,
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
                m = pp.mask_crop(batch["mask"], center, bbox_dim, augm, res,
                                 apply_rot=self.is_train)[..., 0]
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
                d = pp.mask_crop(batch["depth"], center, bbox_dim, augm, res,
                                 apply_rot=self.is_train)[..., 0]
                # per-hand depth: the patch's depth inside the hand's crop box
                xs = torch.arange(res, dtype=torch.float32, device=dev)

                def region(box):
                    in_x = ((xs[None, None, :] >= box[:, 0, None, None])
                            & (xs[None, None, :] < box[:, 2, None, None]))
                    in_y = ((xs[None, :, None] >= box[:, 1, None, None])
                            & (xs[None, :, None] < box[:, 3, None, None]))
                    return (in_x & in_y).to(d.dtype)

                targets["depth.r"] = d * region(r_bbox_noflip)
                targets["depth.l"] = d * region(l_bbox_noflip)
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

    def __call__(self, record_batch: dict,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None):
        # one host->device copy per array; uint8 pixels widen on the device.
        # Values are numpy arrays or (pinned) tensors.
        device_batch = {
            k: (v if torch.is_tensor(v)
                else torch.from_numpy(np.ascontiguousarray(v))).to(
                    self.device, non_blocking=True)
            for k, v in record_batch.items() if not k.startswith("_")
        }
        with torch.no_grad(), f32_exact():
            inputs, targets, meta_info = self._process(device_batch,
                                                       generator, draws)
        if "_dist" in record_batch:
            meta_info["dist"] = record_batch["_dist"]
        return inputs, targets, meta_info


def pin_batch(stacked: dict) -> dict:
    """The arrays of a stacked batch as fresh pinned tensors (the ``_``
    host-side entries stay as they are)."""
    return {k: (v if k.startswith("_") else torch.from_numpy(
        np.ascontiguousarray(v)).pin_memory()) for k, v in stacked.items()}


class DeviceDataLoader:
    """Host dataset of Records -> stream of device-preprocessed batches
    ``(inputs, targets, meta_info)``.

    Record fetches run on a thread pool with a bounded lookahead of batches,
    consumed in submission order, so batch order and augmentation draws equal
    the sequential path's. An iteration has a host half (:meth:`host_batches`:
    fetch, stack, pin; safe on a worker thread) and a device half
    (:meth:`device_batch`: the copy and the preprocessing, drawing from the
    epoch's generator; always on the consumer's thread, so the generator is
    never drawn from by two threads and every launch goes to the consumer's
    stream). Every host batch gets fresh pinned tensors, so a
    ``non_blocking`` copy never races a reuse of its staging memory.

    A dataset with a ``stacked_batch(indices)`` method (a
    :class:`~hands_tpu_torch.data.packed.PackedRecordDataset`) hands out each
    batch already stacked: the host half then fetches no records, and the
    batch goes through the same pinning and device half.

    A tail batch is padded to ``batch_size`` with copies of its last row
    whose ``is_valid`` / ``right_valid`` / ``left_valid`` are 0 (the metrics
    give NaN there); ``meta["num_valid"]`` counts the real rows.
    """

    def __init__(self, dataset, cfg: Config, batch_size: int, is_train: bool,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: Optional[int] = None,
                 lookahead_batches: int = 4, shard: tuple = (0, 1),
                 device="cuda"):
        if tuple(shard) != (0, 1):
            raise NotImplementedError(
                "the sharded (multi-process) loader path is not ported: "
                "ROADMAP queue 1 item 11")
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.is_train = is_train
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = (cfg.num_workers if num_workers is None
                            else num_workers)
        self.lookahead_batches = lookahead_batches
        self.device = torch.device(device)
        self.pre = DevicePreprocessor(cfg, is_train, device=self.device)
        # advances once per full iteration: every epoch reshuffles and draws
        # fresh augmentations; (seed, epoch) -> stream stays deterministic
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch index (as ``DistributedSampler.set_epoch``)."""
        self._epoch = int(epoch)

    def peek(self):
        """First batch of the upcoming epoch WITHOUT advancing the epoch
        counter."""
        epoch = self._epoch
        try:
            return next(iter(self))
        finally:
            self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def begin_epoch(self):
        """Advance the epoch counter; returns (record order, the epoch's
        generator on the loader's device)."""
        epoch = self._epoch
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.is_train:
            np.random.RandomState(self.seed * 100003 + epoch).shuffle(order)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 100003 + epoch)
        return order, gen

    def _iter_record_batches(self, order):
        """Yield the list of Records of each index batch, fetched by a thread
        pool with bounded lookahead (``num_workers`` <= 0: sequentially)."""
        n, step = len(order), self.batch_size
        starts = range(0, n - (step - 1 if self.drop_last else 0), step)
        if self.num_workers <= 0:
            for s in starts:
                yield [self.dataset[int(i)] for i in order[s:s + step]]
            return
        import concurrent.futures as cf
        from collections import deque

        with cf.ThreadPoolExecutor(self.num_workers) as ex:
            pending = deque()
            it = iter(starts)

            def submit():
                s = next(it, None)
                if s is None:
                    return False
                pending.append([ex.submit(self.dataset.__getitem__, int(i))
                                for i in order[s:s + step]])
                return True

            for _ in range(self.lookahead_batches):
                if not submit():
                    break
            while pending:
                futs = pending.popleft()
                submit()
                yield [f.result() for f in futs]

    def _iter_record_stacks(self, order):
        """The record path: yields (stacked padded batch, real rows)."""
        for records in self._iter_record_batches(order):
            n_real = len(records)
            for _ in range(self.batch_size - n_real):
                pad = copy.copy(records[-1])
                pad.is_valid = pad.right_valid = pad.left_valid = 0.0
                records.append(pad)
            yield stack_records(records), n_real

    def _iter_stacked_batches(self, order):
        """The packed path: the dataset stacks each batch itself; the tail
        repeats its last row, invalidated. Yields (stacked, real rows)."""
        n, step = len(order), self.batch_size
        for s in range(0, n - (step - 1 if self.drop_last else 0), step):
            idxs = order[s:s + step]
            stacked = self.dataset.stacked_batch(idxs)
            n_real = len(idxs)
            n_pad = step - n_real
            if n_pad > 0:
                for key, val in stacked.items():
                    if isinstance(val, list):
                        stacked[key] = val + [val[-1]] * n_pad
                    else:
                        stacked[key] = np.concatenate(
                            [val, np.repeat(val[-1:], n_pad, axis=0)])
                for key in ("is_valid", "right_valid", "left_valid"):
                    stacked[key][n_real:] = 0.0
            yield stacked, n_real

    def host_batches(self, order):
        """The host half: yields (stacked batch, number of real rows); arrays
        are pinned tensors when the loader's device is a card."""
        batches = (self._iter_stacked_batches(order)
                   if hasattr(self.dataset, "stacked_batch")
                   else self._iter_record_stacks(order))
        for stacked, n_real in batches:
            if self.device.type == "cuda":
                stacked = pin_batch(stacked)
            yield stacked, n_real

    def device_batch(self, stacked: dict, n_real: int, gen: torch.Generator):
        """The device half: copy, preprocess (drawing from ``gen`` in train
        mode), attach the names and the count of real rows."""
        inputs, targets, meta = self.pre(
            stacked, generator=gen if self.is_train else None)
        meta = XDict(meta)
        meta["imgname"] = stacked["_imgnames"][:n_real]
        meta["num_valid"] = n_real
        return inputs, targets, meta

    def __iter__(self):
        order, gen = self.begin_epoch()
        for stacked, n_real in self.host_batches(order):
            yield self.device_batch(stacked, n_real, gen)


class PrefetchLoader:
    """Background-thread prefetch around a :class:`DeviceDataLoader`: the
    thread runs the loader's host half (record fetch, stacking, pinning)
    ``depth`` batches ahead; the copy to the card and the preprocessing stay
    on the consumer's thread and stream (see :class:`DeviceDataLoader`).
    ``wait_seconds`` adds up the time the consumer was blocked on the queue.
    ``peek`` / ``set_epoch`` / attributes go to the wrapped loader."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth
        self.wait_seconds = 0.0

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        import time

        order, gen = self.loader.begin_epoch()
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.loader.host_batches(order):
                    if not put(item):
                        return
                put(done)
            except BaseException as exc:  # handed to the consumer, re-raised
                put(exc)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self.loader.device_batch(*item, gen)
        finally:
            stop.set()  # an abandoned iteration must not leave the thread
            thread.join(timeout=10.0)
