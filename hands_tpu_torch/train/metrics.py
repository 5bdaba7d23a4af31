"""Batched evaluation metrics (port of ``hands_tpu/train/metrics.py``).

Every metric is a dense batched computation that gives per-example tensors
with NaN for invalid entries; an epoch aggregates them with a nanmean.
Procrustes alignment is one batched SVD (``ops/procrustes.py``).

Registry: ``eval_fn_dict``, keyed "mpjpe.ra", "mpjpe.pa.ra", "mrrpe.rl",
"pix_err", "pck".
"""

from __future__ import annotations

import torch

from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops.procrustes import (similarity_align,
                                            similarity_align_masked)


def _nan_where(cond, x):
    return torch.where(cond, x, torch.full_like(x, torch.nan))


def joint3d_error(gt, pred, valid_sample):
    """Per-joint L2 (B, J); rows of invalid samples are NaN."""
    dist = torch.sqrt(torch.sum((gt - pred) ** 2, dim=2))
    return _nan_where(valid_sample[:, None] > 0, dist)


def pixel_error(gt, pred, valid_jts):
    """Per-joint 2D L2 (B, J); invalid joints are NaN."""
    dist = torch.sqrt(torch.sum((gt - pred) ** 2, dim=2))
    return _nan_where(valid_jts > 0, dist)


def _nanmean(x, dim):
    mask = torch.isfinite(x)
    s = torch.where(mask, x, torch.zeros_like(x)).sum(dim=dim)
    n = mask.sum(dim=dim)
    return _nan_where(n > 0, s / torch.clamp(n, min=1))


def _hand_valid(targets):
    is_valid = targets["is_valid"]
    return (targets["right_valid"] * is_valid,
            targets["left_valid"] * is_valid)


def _root_aligned(x):
    return x - x[:, :1, :]


def eval_mpjpe_ra(pred, targets, meta_info) -> XDict:
    out = XDict()
    rv, lv = _hand_valid(targets)
    err_r = joint3d_error(_root_aligned(targets["mano.j3d.cam.r"]),
                          _root_aligned(pred["mano.j3d.cam.r"]), rv).mean(dim=1)
    err_l = joint3d_error(_root_aligned(targets["mano.j3d.cam.l"]),
                          _root_aligned(pred["mano.j3d.cam.l"]), lv).mean(dim=1)
    out["mpjpe/ra/h"] = _nanmean(torch.stack([err_r, err_l], dim=1),
                                 dim=1) * 1000.0
    return out


def _masked_pa_errors(gt, pr, hand_valid, jv):
    """Per-sample (abs, rao, pa) errors under per-joint 3D validity:

    - root-align by the FIRST VALID joint, not joint 0;
    - means run over valid joints only;
    - the Procrustes fit uses only valid joints;
    - the pa error is multiplied by ``hand_valid`` (an invalid hand scores
      0.0, not NaN);
    - hands with zero valid joints yield NaN for all three.
    """
    jvf = jv > 0
    any_valid = jvf.any(dim=1)
    root_idx = torch.argmax(jvf.to(torch.int32), dim=1)

    def take_root(x):
        return torch.gather(x, 1, root_idx[:, None, None].expand(-1, 1, 3))

    def masked_mean(per_joint):
        m = _nanmean(_nan_where(jvf, per_joint), dim=1)
        return _nan_where(any_valid, m)

    dist_abs = torch.sqrt(torch.sum((gt - pr) ** 2, dim=2))
    abs_err = masked_mean(dist_abs)

    gt_ra = gt - take_root(gt)
    pr_ra = pr - take_root(pr)
    dist_ra = torch.sqrt(torch.sum((gt_ra - pr_ra) ** 2, dim=2))
    rao_err = masked_mean(dist_ra)

    pr_hat = similarity_align_masked(pr_ra, gt_ra, jvf.to(gt.dtype))
    dist_pa = torch.sqrt(torch.sum((gt_ra - pr_hat) ** 2, dim=2))
    pa_err = masked_mean(dist_pa) * hand_valid
    pa_err = _nan_where(any_valid, pa_err)
    return {"abs": abs_err, "rao": rao_err, "ra": pa_err}


def eval_mpjpe_pa_ra(pred, targets, meta_info) -> XDict:
    out = XDict()
    rv, lv = _hand_valid(targets)
    # per-joint 3D validity, where the dataset gives it, selects the masked
    # Procrustes
    jv_r = targets.get("joints3d_valid_r")
    jv_l = targets.get("joints3d_valid_l")

    if jv_r is not None:
        res_r = _masked_pa_errors(
            targets["mano.j3d.cam.r"], pred["mano.j3d.cam.r"], rv, jv_r)
        res_l = _masked_pa_errors(
            targets["mano.j3d.cam.l"], pred["mano.j3d.cam.l"], lv, jv_l)
        for name in ("abs", "rao", "ra"):
            err_r, err_l = res_r[name], res_l[name]
            out[f"mpjpe/pa/{name}/r"] = err_r * 1000.0
            out[f"mpjpe/pa/{name}/l"] = err_l * 1000.0
            out[f"mpjpe/pa/{name}/h"] = _nanmean(
                torch.stack([err_r, err_l], dim=1), dim=1) * 1000.0
        return out

    def pa_err(gt, pr, valid):
        gt_ra = _root_aligned(gt)
        pr_hat = similarity_align(_root_aligned(pr), gt_ra)
        return joint3d_error(gt_ra, pr_hat, valid).mean(dim=1)

    err_r = pa_err(targets["mano.j3d.cam.r"], pred["mano.j3d.cam.r"], rv)
    err_l = pa_err(targets["mano.j3d.cam.l"], pred["mano.j3d.cam.l"], lv)
    out["mpjpe/pa/ra/h"] = _nanmean(torch.stack([err_r, err_l], dim=1),
                                    dim=1) * 1000.0
    return out


def eval_mrrpe_rl(pred, targets, meta_info) -> XDict:
    out = XDict()
    valid = (targets["right_valid"] * targets["left_valid"]
             * targets["is_valid"])
    rel_gt = targets["mano.j3d.cam.l"][:, 0] - targets["mano.j3d.cam.r"][:, 0]
    rel_pred = pred["mano.j3d.cam.l"][:, 0] - pred["mano.j3d.cam.r"][:, 0]
    err = torch.sqrt(torch.sum((rel_pred - rel_gt) ** 2, dim=1))
    out["mrrpe/r/l"] = _nan_where(valid > 0, err) * 1000.0
    return out


def _pixel_errors(pred, targets):
    rv, lv = _hand_valid(targets)
    pix_r = pixel_error(targets["mano.j2d.r"][..., :2], pred["mano.j2d.r"],
                        targets["joints_valid_r"] * rv[:, None])
    pix_l = pixel_error(targets["mano.j2d.l"][..., :2], pred["mano.j2d.l"],
                        targets["joints_valid_l"] * lv[:, None])
    return pix_r, pix_l


def eval_pix_err(pred, targets, meta_info) -> XDict:
    out = XDict()
    pix_r, pix_l = _pixel_errors(pred, targets)
    out["pix_err/r"] = pix_r
    out["pix_err/l"] = pix_l
    out["pix_err/h"] = torch.cat([pix_r, pix_l], dim=1)
    return out


def eval_pck(pred, targets, meta_info, thresholds=(5.0, 10.0, 15.0)) -> XDict:
    """PCK@px over both hands: the share of valid joints within each pixel
    threshold."""
    pix = torch.cat(_pixel_errors(pred, targets), dim=1)
    out = XDict()
    for t in thresholds:
        hit = _nan_where(torch.isfinite(pix), (pix < t).to(torch.float32))
        out[f"pck/{t:.0f}px"] = _nanmean(hit, dim=1) * 100.0
    return out


eval_fn_dict = {
    "mpjpe.ra": eval_mpjpe_ra,
    "mpjpe.pa.ra": eval_mpjpe_pa_ra,
    "mrrpe.rl": eval_mrrpe_rl,
    "pix_err": eval_pix_err,
    "pck": eval_pck,
}


def evaluate_metrics(pred, targets, meta_info, specs) -> XDict:
    out = XDict()
    for key in specs:
        out.merge(eval_fn_dict[key](pred, targets, meta_info))
    return out
