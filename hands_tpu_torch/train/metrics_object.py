"""Object, interaction and sequence metrics of the ArcticNet evaluation
(port of ``hands_tpu/train/metrics_object.py``).

The dense metrics are batched tensor functions: ragged object meshes come
padded with a mask, and NaN marks an invalid sample, as in the hand
metrics. The motion deviation's window mining runs on the host in numpy
(an own copy of the JAX module's), with the reference's quirks kept: the
NaN triangle of the sliding-contact filter is sized ``window_thres``, not
the window's length; a window still in contact at the last frame is
dropped; and the matched object vertex is the smallest mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.core.tree_utils import nanmean as _nanmean
from hands_tpu_torch.core.xdict import XDict


def _nan_where(keep, x):
    return torch.where(keep, x, torch.full_like(x, float("nan")))


def _obj_root(v, meta_info):
    """Object root (B, 3): the mean of the bottom part's (id 2) valid
    vertices."""
    mask = meta_info["object.v.mask"]
    bottom = (meta_info["part_ids"] == 2) * mask
    w = bottom / torch.clamp(bottom.sum(dim=1, keepdim=True), min=1)
    return torch.einsum("bv,bvc->bc", w, v)


# ------------------------------------------------------------------ aae
def eval_degree(pred, targets, meta_info) -> XDict:
    """Absolute articulation-angle error in degrees."""
    err = torch.abs(pred["object.radian"].reshape(-1)
                    - targets["object.radian"].reshape(-1))
    out = XDict()
    out["aae"] = _nan_where(targets["is_valid"] > 0, err * 180.0 / math.pi)
    return out


# ---------------------------------------------------------- success rate
@f32_matmuls
def eval_v2v_success(pred, targets, meta_info, alpha: float = 0.05) -> XDict:
    """Root-aligned object v2v success rate at alpha x diameter (root: the
    mean of the bottom part's vertices)."""
    v_gt = targets["object.v.cam"]  # (B, Vmax, 3)
    v_pred = pred["object.v.cam"]
    mask = meta_info["object.v.mask"]  # (B, Vmax) 1 = valid vertex
    ra_gt = v_gt - _obj_root(v_gt, meta_info)[:, None]
    ra_pred = v_pred - _obj_root(v_pred, meta_info)[:, None]
    d = torch.sqrt(torch.sum((ra_gt - ra_pred) ** 2, dim=2))  # (B, Vmax)
    thresh = meta_info["diameter"][:, None] * alpha
    hit = (d < thresh) * mask
    rate = hit.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1) * 100.0
    out = XDict()
    out[f"success_rate/{alpha:.2f}"] = _nan_where(targets["is_valid"] > 0,
                                                  rate)
    return out


# ----------------------------------------------------------------- cdev
def contact_deviation(pred_v3d_o, pred_v3d_h, dist_ho, idx_ho, is_valid,
                      hand_valid, contact_dist: float = 3e-3):
    """Mean distance of the in-contact hand vertices to their matched object
    vertices: (B,) metres, NaN where invalid."""
    idx = idx_ho.long()[:, :, None].expand(-1, -1, 3)
    disp = torch.gather(pred_v3d_o, 1, idx) - pred_v3d_h  # (B, Vh, 3)
    cd = torch.sqrt(torch.sum(disp * disp, dim=2))
    valid = (hand_valid * is_valid)[:, None] * (dist_ho <= contact_dist)
    return _nanmean(_nan_where(valid > 0, cd), dim=1)


def eval_contact_deviation(pred, targets, meta_info) -> XDict:
    cd_ro = contact_deviation(
        pred["object.v.cam"], pred["mano.v3d.cam.r"], targets["dist.ro"],
        targets["idx.ro"], targets["is_valid"], targets["right_valid"])
    cd_lo = contact_deviation(
        pred["object.v.cam"], pred["mano.v3d.cam.l"], targets["dist.lo"],
        targets["idx.lo"], targets["is_valid"], targets["left_valid"])
    out = XDict()
    out["cdev/ho"] = _nanmean(torch.stack([cd_ro, cd_lo], 1), dim=1) * 1000.0
    return out


# ---------------------------------------------------------- field errors
def eval_field_errors(pred, targets, meta_info) -> XDict:
    """Mean |gt - pred| of the hand <-> object distance fields: dist.ro/.lo
    per MANO vertex, dist.or/.ol per object vertex masked by
    ``object.v.mask``."""
    is_valid = targets["is_valid"]
    obj_mask = meta_info["object.v.mask"]

    def avg_err(key, mask=None):
        diff = torch.abs(targets[key] - pred[key])
        if mask is not None:
            diff = _nan_where(mask > 0, diff)
        return _nan_where(is_valid > 0, _nanmean(diff, dim=1))

    ro, lo = avg_err("dist.ro"), avg_err("dist.lo")
    or_, ol = avg_err("dist.or", obj_mask), avg_err("dist.ol", obj_mask)
    out = XDict()
    out["avg/ho"] = _nanmean(torch.stack([ro, lo], 1), dim=1) * 1000.0
    out["avg/oh"] = _nanmean(torch.stack([or_, ol], 1), dim=1) * 1000.0
    return out


# ---------------------------------------------------------- acceleration
def compute_error_accel(joints_gt, joints_pred, fps: float = 30.0):
    """Sequence acceleration error: the central difference [1, -2, 1] / h^2
    over the frame axis. (N, J, 3) -> (N - 2,)."""
    h = 1.0 / fps
    acc_gt = (joints_gt[:-2] - 2 * joints_gt[1:-1] + joints_gt[2:]) / h**2
    acc_pred = (joints_pred[:-2] - 2 * joints_pred[1:-1]
                + joints_pred[2:]) / h**2
    return torch.linalg.norm(acc_pred - acc_gt, dim=2).mean(dim=1)


def _acc_window_valid(valid):
    """The acceleration at step t needs frames t-1, t, t+1 valid:
    (T,) -> (T - 2,) bool."""
    return (valid[:-2] * valid[1:-1] * valid[2:]) > 0


def _nan_pad_ends(x):
    """One NaN at each end, so the metric has one entry a frame."""
    pad = torch.full((1,), float("nan"), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x, pad])


@f32_matmuls
def eval_acc_pose(pred, targets, meta_info, fps: float = 30.0) -> XDict:
    """Per-sequence acceleration error of the root-aligned hand and object
    vertices (hand root: joint 0; object root: the bottom part's mean);
    frames next to invalid ones are NaN; m/s^2."""
    is_valid = targets["is_valid"]
    right_valid = targets["right_valid"] * is_valid
    left_valid = targets["left_valid"] * is_valid

    def ra(d, key, root_key):
        if root_key == "object":
            return d[key] - _obj_root(d[key], meta_info)[:, None]
        return d[key] - d[root_key][:, :1]

    def seq_err(key, root_key, valid):
        e = compute_error_accel(ra(targets, key, root_key),
                                ra(pred, key, root_key), fps)
        return _nan_where(_acc_window_valid(valid), e)

    acc_r = seq_err("mano.v3d.cam.r", "mano.j3d.cam.r", right_valid)
    acc_l = seq_err("mano.v3d.cam.l", "mano.j3d.cam.l", left_valid)
    acc_o = seq_err("object.v.cam", "object", is_valid)
    out = XDict()
    out["acc/h"] = _nan_pad_ends(
        _nanmean(torch.stack([acc_r, acc_l], 1), dim=1))
    # the reference never pads acc/o back to one entry a frame
    out["acc/o"] = acc_o
    return out


def eval_acc_field(pred, targets, meta_info, fps: float = 30.0) -> XDict:
    """Acceleration error of the hand <-> object distance fields: the
    central-difference acceleration of each per-vertex field, |pred - gt|
    averaged over the vertices; the hand -> object legs windowed by their
    hand's validity, the object -> hand legs by ``is_valid``; the two legs
    of each direction nanmean-ed; NaN end padding."""
    is_valid = targets["is_valid"]
    right_valid = targets["right_valid"] * is_valid
    left_valid = targets["left_valid"] * is_valid
    obj_mask = meta_info["object.v.mask"] if meta_info is not None else None
    h = 1.0 / fps

    def field_acc_err(gt, pr, vmask=None):
        a_gt = (gt[:-2] - 2 * gt[1:-1] + gt[2:]) / h**2
        a_pr = (pr[:-2] - 2 * pr[1:-1] + pr[2:]) / h**2
        e = torch.abs(a_pr - a_gt)  # (T - 2, V)
        if vmask is not None:
            # padded object vertices drop out of the vertex mean
            return _nanmean(_nan_where(vmask[1:-1] > 0, e), dim=1)
        return e.mean(dim=1)

    acc_ro = field_acc_err(targets["dist.ro"], pred["dist.ro"])
    acc_lo = field_acc_err(targets["dist.lo"], pred["dist.lo"])
    acc_or = field_acc_err(targets["dist.or"], pred["dist.or"], obj_mask)
    acc_ol = field_acc_err(targets["dist.ol"], pred["dist.ol"], obj_mask)

    acc_ro = _nan_where(_acc_window_valid(right_valid), acc_ro)
    acc_lo = _nan_where(_acc_window_valid(left_valid), acc_lo)
    acc_or = _nan_where(_acc_window_valid(is_valid), acc_or)
    acc_ol = _nan_where(_acc_window_valid(is_valid), acc_ol)

    out = XDict()
    out["acc/ho"] = _nan_pad_ends(
        _nanmean(torch.stack([acc_ro, acc_lo], 1), dim=1))
    out["acc/oh"] = _nan_pad_ends(
        _nanmean(torch.stack([acc_or, acc_ol], 1), dim=1))
    return out


# ------------------------------------------------------- motion deviation
def find_contact_windows(
    dist: np.ndarray,  # (T, 778) closest-object distance per MANO vertex
    dist_idx: np.ndarray,  # (T, 778) matched object vertex ids
    vo: np.ndarray,  # (Vo, 3) canonical object vertices
    contact_thres: float = 3e-3,
    window_thres: int = 15,
) -> np.ndarray:
    """Continuous-contact windows [start, end, hand_vid, obj_vid], by
    run-length encoding over time. The sliding-contact filter is the
    nanmean of the pairwise canonical-object distances with the upper
    triangle of size ``window_thres`` removed; a window that reaches the
    last frame is dropped; the object vertex is the mode of the per-frame
    matches (the smallest one on a tie)."""
    T, V = np.shape(dist)
    contacts = np.asarray(dist) < contact_thres
    dist_idx = np.asarray(dist_idx)
    vo = np.asarray(vo)
    cand = np.nonzero(contacts.sum(axis=0) >= window_thres)[0]
    triu = np.triu_indices(window_thres)
    windows = []
    for vidx in cand:
        padded = np.concatenate([[0], contacts[:, vidx].astype(np.int8), [0]])
        delta = np.diff(padded)
        starts = np.nonzero(delta == 1)[0]
        ends = np.nonzero(delta == -1)[0] - 1
        for s, e in zip(starts, ends):
            if e == T - 1:
                continue  # never closed by a contact -> no-contact step
            if e - s + 1 < window_thres:
                continue
            j_list = dist_idx[s:e + 1, vidx]
            vj = vo[j_list]
            cdist = np.linalg.norm(vj[:, None, :] - vj[None, :, :], axis=-1)
            cdist[triu] = np.nan  # sized window_thres, as the reference
            if np.nanmean(cdist) > contact_thres:
                continue  # the finger slid along the object's surface
            vals, counts = np.unique(j_list, return_counts=True)
            windows.append([s, e, vidx, int(vals[np.argmax(counts)])])
    return np.asarray(windows, np.int64).reshape(-1, 4)


def compute_mdev_windows(windows: np.ndarray, v_hand: np.ndarray,
                         v_obj: np.ndarray,
                         frame_valid: np.ndarray = None) -> np.ndarray:
    """Motion deviation of each window (W,) in metres: the hand vertex and
    its matched object vertex must move alike inside a contact window; a
    frame-to-frame difference counts only where both frames are valid."""
    if frame_valid is None:
        frame_valid = np.ones(v_hand.shape[0])
    frame_valid = np.asarray(frame_valid, bool)
    out = []
    for s, e, i, j in windows:
        diff = np.diff(v_hand[s:e + 1, i], axis=0) - \
            np.diff(v_obj[s:e + 1, j], axis=0)
        valid = frame_valid[s:e + 1]
        diff_valid = valid[1:] & valid[:-1]
        norms = np.where(diff_valid, np.linalg.norm(diff, axis=1), np.nan)
        out.append(np.nanmean(norms) if diff_valid.any() else np.nan)
    return np.asarray(out, np.float64)


def compute_mdev(v_hand: np.ndarray, v_obj: np.ndarray, windows: np.ndarray,
                 frame_valid: np.ndarray = None) -> float:
    """The sequence's mdev in mm (mean over its contact windows)."""
    if len(windows) == 0:
        return float("nan")
    per_win = compute_mdev_windows(windows, v_hand, v_obj, frame_valid)
    return float(np.nanmean(per_win) * 1000.0)


@f32_matmuls
def eval_mrrpe_ro(pred, targets, meta_info) -> XDict:
    """Right-hand root to object root relative position error (object
    root: the bottom part's mean)."""
    rv = targets["right_valid"] * targets["is_valid"]
    rel_gt = _obj_root(targets["object.v.cam"], meta_info) - \
        targets["mano.j3d.cam.r"][:, 0]
    rel_pr = _obj_root(pred["object.v.cam"], meta_info) - \
        pred["mano.j3d.cam.r"][:, 0]
    err = torch.sqrt(torch.sum((rel_pr - rel_gt) ** 2, dim=1))
    out = XDict()
    out["mrrpe/r/o"] = _nan_where(rv > 0, err) * 1000.0
    return out


def compute_v2v_dist(v_gt, v_pred, mask, is_valid):
    """Per-vertex L2 over padded meshes, NaN where masked or invalid."""
    d = torch.sqrt(torch.sum((v_gt - v_pred) ** 2, dim=2))
    d = _nan_where(mask > 0, d)
    return _nan_where(is_valid[:, None] > 0, d)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def eval_motion_deviation(v_hand_seq, v_obj_seq, dist_seq, dist_idx_seq,
                          vo_canonical, contact_thres: float = 3e-3,
                          window_thres: int = 15,
                          frame_valid=None) -> float:
    """Sequence mdev (3 mm contact, 15-frame windows): the contact windows
    of the ground-truth distance fields, then the relative drift of hand
    and object in them. Host side."""
    windows = find_contact_windows(
        _host(dist_seq), _host(dist_idx_seq), _host(vo_canonical),
        contact_thres, window_thres)
    return compute_mdev(_host(v_hand_seq), _host(v_obj_seq), windows,
                        None if frame_valid is None else _host(frame_valid))


object_eval_fn_dict = {
    "mrrpe.ro": eval_mrrpe_ro,
    "aae": eval_degree,
    "success_rate": eval_v2v_success,
    "cdev": eval_contact_deviation,
    "avg_err_field": eval_field_errors,
    "acc_err_pose": eval_acc_pose,
    "acc_err_field": eval_acc_field,
}
