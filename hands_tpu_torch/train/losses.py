"""Flag-gated multi-dataset loss (port of ``hands_tpu/train/losses.py``).

Every term is computed densely and multiplied by per-sample validity and
per-dataset supervision flags (``is_j2d_loss`` etc.). Weights: pose 10,
kp2d/kp3d 5, beta 1e-3, cam/transl 1, grasp 0.1, mask 10, depth 1. Nothing
here reads a value back to the host: the zero guards are tensor ``where``s.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from hands_tpu_torch.config import Config
from hands_tpu_torch.core import rot as rotlib

LossDict = Dict[str, Tuple[torch.Tensor, float]]


def _mse(a, b):
    return (a - b) ** 2


def _l1(a, b):
    return torch.abs(a - b)


def vector_loss(pred, gt, valid, criterion=_mse):
    """Elementwise criterion masked by per-sample validity -> (B, D) flat;
    all zeros when no sample of the batch is valid."""
    B = pred.shape[0]
    dist = criterion(pred, gt).reshape(B, -1)
    dist = dist * valid.reshape(B, 1)
    return torch.where(valid.sum() > 0, dist, torch.zeros_like(dist))


def joints_loss(pred, gt, jts_valid, criterion=_mse):
    """Per-joint criterion masked by per-joint validity -> (B, J*C) flat."""
    dist = criterion(pred, gt) * jts_valid[:, :, None]
    return dist.reshape(dist.shape[0], -1)


def hand_kp3d_loss(pred_3d, gt_3d, jts_valid, criterion=_mse):
    """Root-aligned 3D keypoint loss."""
    pred_ra = pred_3d - pred_3d[:, :1]
    gt_ra = gt_3d - gt_3d[:, :1]
    return joints_loss(pred_ra, gt_ra, jts_valid, criterion)


def grasp_ce_loss(logits, labels, valid):
    """9-way grasp cross-entropy per sample, masked. labels: int (B,);
    valid (B,)."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    return (ce * valid).reshape(-1, 1)


def render_l1_loss(pred_mask, gt_mask, valid):
    B = pred_mask.shape[0]
    dist = _l1(pred_mask, gt_mask).reshape(B, -1)
    return dist * valid.reshape(B, 1)


def compute_loss_light(pred, targets, meta_info, cfg: Config) -> LossDict:
    """Returns dict of key -> (scalar unweighted loss, weight)."""
    B = targets["mano.pose.r"].shape[0]

    gt_pose_r = rotlib.axis_angle_to_matrix(
        targets["mano.pose.r"].reshape(B, 16, 3))
    gt_pose_l = rotlib.axis_angle_to_matrix(
        targets["mano.pose.l"].reshape(B, 16, 3))

    is_valid = targets["is_valid"]
    right_valid = targets["right_valid"] * is_valid
    left_valid = targets["left_valid"] * is_valid
    jv_r = targets["joints_valid_r"]
    jv_l = targets["joints_valid_l"]

    f_cam = meta_info["is_cam_loss"].reshape(B, 1)
    f_j2d = meta_info["is_j2d_loss"].reshape(B, 1)
    f_j3d = meta_info["is_j3d_loss"].reshape(B, 1)
    f_pose = meta_info["is_pose_loss"].reshape(B, 1)
    f_beta = meta_info["is_beta_loss"].reshape(B, 1)

    # MANO parameter losses
    l_pose_r = vector_loss(pred["mano.pose.r"], gt_pose_r, right_valid) * f_pose
    l_pose_l = vector_loss(pred["mano.pose.l"], gt_pose_l, left_valid) * f_pose
    l_beta_r = vector_loss(pred["mano.beta.r"], targets["mano.beta.r"],
                           right_valid) * f_beta
    l_beta_l = vector_loss(pred["mano.beta.l"], targets["mano.beta.l"],
                           left_valid) * f_beta

    # 2D reprojection
    l_kp2d_r = joints_loss(pred["mano.j2d.norm.r"],
                           targets["mano.j2d.norm.r"][..., :2], jv_r) * f_j2d
    l_kp2d_l = joints_loss(pred["mano.j2d.norm.l"],
                           targets["mano.j2d.norm.l"][..., :2], jv_l) * f_j2d

    # root-aligned 3D
    l_kp3d_r = hand_kp3d_loss(pred["mano.j3d.cam.r"],
                              targets["mano.j3d.cam.r"], jv_r) * f_j3d
    l_kp3d_l = hand_kp3d_loss(pred["mano.j3d.cam.l"],
                              targets["mano.j3d.cam.l"], jv_l) * f_j3d

    # relative translation + camera losses (with init-head supervision)
    l_transl = vector_loss(
        pred["mano.cam_t.wp.l"] - pred["mano.cam_t.wp.r"],
        targets["mano.cam_t.wp.l"] - targets["mano.cam_t.wp.r"],
        right_valid * left_valid) * f_cam
    l_cam_r = (
        vector_loss(pred["mano.cam_t.wp.r"], targets["mano.cam_t.wp.r"],
                    right_valid)
        + vector_loss(pred["mano.cam_t.wp.init.r"], targets["mano.cam_t.wp.r"],
                      right_valid)) * f_cam
    l_cam_l = (
        vector_loss(pred["mano.cam_t.wp.l"], targets["mano.cam_t.wp.l"],
                    left_valid)
        + vector_loss(pred["mano.cam_t.wp.init.l"], targets["mano.cam_t.wp.l"],
                      left_valid)) * f_cam

    loss_dict: LossDict = {
        "loss/mano/cam_t/r": (l_cam_r.mean(), 1.0),
        "loss/mano/cam_t/l": (l_cam_l.mean(), 1.0),
        "loss/mano/kp2d/r": (l_kp2d_r.mean(), 5.0),
        "loss/mano/kp3d/r": (l_kp3d_r.mean(), 5.0),
        "loss/mano/pose/r": (l_pose_r.mean(), 10.0),
        "loss/mano/beta/r": (l_beta_r.mean(), 0.001),
        "loss/mano/kp2d/l": (l_kp2d_l.mean(), 5.0),
        "loss/mano/kp3d/l": (l_kp3d_l.mean(), 5.0),
        "loss/mano/pose/l": (l_pose_l.mean(), 10.0),
        "loss/mano/transl/l": (l_transl.mean(), 1.0),
        "loss/mano/beta/l": (l_beta_l.mean(), 0.001),
    }

    if cfg.use_grasp_loss:
        f_grasp = meta_info["is_grasp_loss"].reshape(B, 1)
        for s in "rl":
            l_grasp = grasp_ce_loss(pred[f"grasp.{s}"], targets[f"grasp.{s}"],
                                    targets[f"grasp_valid_{s}"]) * f_grasp
            loss_dict[f"loss/grasp/{s}"] = (l_grasp.mean(), 0.1)

    if cfg.use_render_seg_loss:
        f_mask = meta_info["is_mask_loss"].reshape(B, 1)
        for s in "rl":
            l_mask = render_l1_loss(pred[f"render.{s}"], targets[f"render.{s}"],
                                    targets[f"render_valid_{s}"]) * f_mask
            loss_dict[f"loss/mask/{s}"] = (l_mask.mean(), 10.0)

    if cfg.use_depth_loss:
        f_depth = meta_info["is_depth_loss"].reshape(B, 1)
        for s in "rl":
            l_depth = _l1(pred[f"depth.{s}"],
                          targets[f"depth.{s}"]).reshape(B, -1) * f_depth
            loss_dict[f"loss/depth/{s}"] = (l_depth.mean(), 1.0)

    if cfg.regress_center_corner:
        for name in ("center", "corner"):
            for s, valid in (("r", right_valid), ("l", left_valid)):
                loss_dict[f"loss/{name}/{s}"] = (
                    vector_loss(pred[f"{name}.{s}"], targets[f"{name}.{s}"],
                                valid).mean(), 1.0)

    return loss_dict


def total_loss(loss_dict: LossDict) -> torch.Tensor:
    return sum(v * w for v, w in loss_dict.values())
