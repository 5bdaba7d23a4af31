"""ARCTIC's offline ground-truth build: raw mocap parameters -> per-sequence
training labels (port of ``hands_tpu/data/arctic_processing.py``).

Per sequence: world-frame MANO of both hands (``mano_forward``, so K1,
``lbs_apply``, on CUDA tensors), the articulated object and, when the
sequence ships ``smplx.npy``, the SMPL-X body; world -> camera for the 9
views (1 egocentric + 8 fixed); the 2D projection, through the lens
distortion for the egocam; the crop boxes (the fixed 2800 x 2000 ego crop,
object-driven fixed-camera boxes of at least 600 px); and the in-frame
validity flags. The raw files are read once and moved to the caller's
device once; every stage runs there, float32 with TF32 off.

``build_split`` concatenates processed sequences into
``{setup}_{split}.npy`` with the merged payload keys (``params``, ``2d``,
``bbox``, ...), as the JAX package writes it; the ARCTIC loader reads
another schema (``{"data_dict", "imgnames"}``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core import transforms as tf
from hands_tpu_torch.core.object_tensors import (OBJECTS,
                                                 build_object_tensors,
                                                 object_forward_7d)
from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.ops import mano as manolib

EGO_IMAGE_SIZE = (2800, 2000)  # (w, h)
_POINT_SETS = ("joints.", "verts.", "kp3d.", "bbox3d.")


# ------------------------------------------------------------------ world FK
@torch.no_grad()
def forward_gt_world(params: Dict[str, torch.Tensor], obj_name: str,
                     smplx_params: Dict[str, torch.Tensor] | None = None):
    """World-frame FK of both hands, the object and, when its parameter
    bundle is given, the SMPL-X body, on the device of ``params``.

    params: rot_r/pose_r/trans_r/shape_r (and _l), obj_arti/obj_rot/
    obj_trans, all (T, ...) over the sequence (ARCTIC's raw ``mano.npy`` /
    ``obj.npy`` layout). smplx_params: the ``smplx.npy`` dict (transl,
    global_orient, body_pose, jaw_pose, leye_pose, reye_pose,
    left_hand_pose, right_hand_pose)."""
    dev = params["obj_arti"].device
    out = {}
    if smplx_params is not None:
        from hands_tpu_torch.ops import smplx_body

        bo = smplx_body.body_forward(
            smplx_body.load_body_model(device=dev),
            global_orient=smplx_params["global_orient"],
            body_pose=smplx_params["body_pose"],
            jaw_pose=smplx_params["jaw_pose"],
            leye_pose=smplx_params["leye_pose"],
            reye_pose=smplx_params["reye_pose"],
            left_hand_pose=smplx_params["left_hand_pose"],
            right_hand_pose=smplx_params["right_hand_pose"],
            transl=smplx_params["transl"],
        )
        out["verts.smplx"] = bo.vertices
        out["joints.smplx"] = bo.joints
    for side, name in (("r", "right"), ("l", "left")):
        mo = manolib.mano_forward(
            manolib.load_mano(side == "r", device=dev),
            betas=params[f"shape_{side}"],
            hand_pose=params[f"pose_{side}"],
            global_orient=params[f"rot_{side}"],
            transl=params[f"trans_{side}"],
        )
        out[f"joints.{name}"] = mo.joints
        out[f"verts.{name}"] = mo.vertices
        out[f"rot_{side}_world"] = params[f"rot_{side}"]

    T = params["obj_arti"].shape[0]
    obj = object_forward_7d(
        build_object_tensors(device=dev),
        angles=params["obj_arti"].reshape(T, 1),
        global_orient=params["obj_rot"],
        transl=None,
        obj_idx=torch.full((T,), OBJECTS.index(obj_name), dtype=torch.long,
                           device=dev),
    )
    # the object template is in mm; the world frame is metres
    trans = params["obj_trans"][:, None] / 1000.0
    out["verts.object"] = obj["v"] / 1000.0 + trans
    out["kp3d.object"] = obj["kp3d"] / 1000.0 + trans
    out["bbox3d.object"] = obj["bbox3d"] / 1000.0 + trans
    out["object.radian"] = params["obj_arti"]
    out["object.v_len"] = obj["v_len"]
    out["object.parts_ids"] = obj["parts_ids"]
    return out


# --------------------------------------------------------------- world2cam
@f32_matmuls
def forward_world2cam(out_world: dict, world2cam: torch.Tensor) -> List[dict]:
    """Every world-frame point set in each of the V views, and the
    camera-frame global orientations. world2cam: (V, T, 4, 4) or
    (V, 4, 4). Returns a list of V dicts."""
    views = []
    for v in range(world2cam.shape[0]):
        w2c = world2cam[v]
        view = {}
        for key, val in out_world.items():
            if key.startswith(_POINT_SETS):
                w2c_b = w2c.expand(val.shape[0], 4, 4) if w2c.ndim == 2 \
                    else w2c
                view[key] = tf.transform_points(w2c_b, val)
            elif key.startswith("rot_") and key.endswith("_world"):
                # camera-frame global orientation: R_cam = R_w2c @ R_world
                R_world = rotlib.axis_angle_to_matrix(val)
                R_w2c = w2c[..., :3, :3]
                if R_w2c.ndim == 2:
                    R_w2c = R_w2c.expand(R_world.shape)
                view[key.replace("_world", "_cam")] = \
                    rotlib.matrix_to_axis_angle(R_w2c @ R_world)
        views.append(view)
    return views


# ---------------------------------------------------------------- project2d
def forward_project2d(views: List[dict], intris_mat: torch.Tensor,
                      ego_dist_coeffs: torch.Tensor | None = None) -> dict:
    """Every camera-space point set in pixels, (T, V, N, 2) a key. View 0
    is the egocam: its points go through the lens distortion first."""
    out2d = {}
    for v, view in enumerate(views):
        K = intris_mat[v]
        for key, pts in view.items():
            if not key.startswith(_POINT_SETS):
                continue
            if v == 0 and ego_dist_coeffs is not None:
                pts = tf.distort_pts3d(pts, ego_dist_coeffs)
            px = tf.project2d(K.expand(pts.shape[0], 3, 3), pts)
            out2d.setdefault(key, []).append(px)
    return {k: torch.stack(v, dim=1) for k, v in out2d.items()}


# -------------------------------------------------------------------- bbox
def compute_bbox_from_kp2d(kp2d: torch.Tensor,
                           obj_scale: float = 0.6) -> torch.Tensor:
    """Square box (cx, cy, scale = side / 200 px) around 2D points."""
    lo = kp2d.min(dim=-2).values
    hi = kp2d.max(dim=-2).values
    center = (lo + hi) / 2.0
    dim = torch.clamp(hi - lo, min=0.0).max(dim=-1).values + obj_scale
    return torch.cat([center, (dim / 200.0)[..., None]], dim=-1)


def forward_define_bbox(out2d: dict, obj_scale: float = 0.6) -> torch.Tensor:
    """Per-view crops (T, V, 3): the fixed full-frame ego box, and boxes
    around the object's first 9 (padded) vertices for the fixed cameras,
    at least 600 px."""
    obj9 = out2d["verts.object"][:, :, :9]
    bbox = compute_bbox_from_kp2d(obj9, obj_scale)
    ego = torch.tensor([EGO_IMAGE_SIZE[0] / 2.0, EGO_IMAGE_SIZE[1] / 2.0,
                        EGO_IMAGE_SIZE[0] / 200.0], dtype=bbox.dtype,
                       device=bbox.device)
    bbox = bbox.clone()
    bbox[:, 0] = ego
    bbox[:, 1:, 2] = torch.clamp(bbox[:, 1:, 2], min=3.0)
    return bbox


# -------------------------------------------------------------------- valid
def forward_valid(bbox: torch.Tensor, j2d_r: torch.Tensor,
                  j2d_l: torch.Tensor, image_sizes: torch.Tensor) -> dict:
    """Per-joint flags (inside both the image and the crop box) and
    per-hand flags (at least 3 valid joints). j2d (T, V, J, 2); bbox
    (T, V, 3); image_sizes (V, 2) [w, h]."""
    def jts_valid(j2d):
        cx, cy, sc = bbox[..., 0:1], bbox[..., 1:2], bbox[..., 2:3]
        half = sc * 200.0 / 2.0
        x, y = j2d[..., 0], j2d[..., 1]
        in_crop = ((x >= cx - half) & (x <= cx + half)
                   & (y >= cy - half) & (y <= cy + half))
        w = image_sizes[None, :, 0:1]
        h = image_sizes[None, :, 1:2]
        in_img = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        return (in_crop & in_img).float()

    jv_r = jts_valid(j2d_r)
    jv_l = jts_valid(j2d_l)
    return {
        "joints_valid_r": jv_r,
        "joints_valid_l": jv_l,
        "right_valid": (jv_r.sum(-1) >= 3).float(),
        "left_valid": (jv_l.sum(-1) >= 3).float(),
    }


# ---------------------------------------------------------------- pipeline
def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def process_seq(seq_dir: str, out_dir: str, export_verts: bool = False,
                device="cuda") -> str:
    """One raw ARCTIC sequence directory (``mano.npy``, ``obj.npy``,
    optional ``smplx.npy``; cameras in ``../../meta/misc.json``) -> its
    labels file ``<out_dir>/<subject>_<seq>.npy``. Runs on ``device``."""
    mano_p = os.path.join(seq_dir, "mano.npy")
    obj_p = os.path.join(seq_dir, "obj.npy")
    smplx_p = os.path.join(seq_dir, "smplx.npy")
    if not (os.path.exists(mano_p) and os.path.exists(obj_p)):
        raise FileNotFoundError(f"raw ARCTIC sequence not found at {seq_dir}")
    mano_data = np.load(mano_p, allow_pickle=True).item()
    obj_data = _f32(np.load(obj_p, allow_pickle=True), device)
    smplx_params = None
    if os.path.exists(smplx_p):
        smplx_raw = np.load(smplx_p, allow_pickle=True).item()
        smplx_params = {k: _f32(v, device) for k, v in smplx_raw.items()}

    seq_name = os.path.basename(seq_dir)
    obj_name = seq_name.split("_")[0]

    params = {}
    for side, name in (("r", "right"), ("l", "left")):
        hand = mano_data[name]
        T = len(hand["rot"])
        params[f"rot_{side}"] = _f32(hand["rot"], device)
        params[f"pose_{side}"] = _f32(hand["pose"], device)
        params[f"trans_{side}"] = _f32(hand["trans"], device)
        params[f"shape_{side}"] = _f32(hand["shape"], device).reshape(
            1, 10).expand(T, 10)
    params["obj_arti"] = obj_data[:, 0]
    params["obj_rot"] = obj_data[:, 1:4]
    params["obj_trans"] = obj_data[:, 4:7]

    meta_p = os.path.join(os.path.dirname(os.path.dirname(seq_dir)),
                          "meta/misc.json")
    sid = os.path.basename(os.path.dirname(seq_dir))
    with open(meta_p) as f:
        misc = json.load(f)[sid]
    world2cam = _f32(misc["world2cam"], device)  # (V, 4, 4)
    intris = _f32(misc["intris_mat"], device)  # (V, 3, 3)
    dist = _f32(misc.get("dist8", np.zeros(8)), device)

    out_world = forward_gt_world(params, obj_name, smplx_params=smplx_params)
    views = forward_world2cam(out_world, world2cam)
    out2d = forward_project2d(views, intris, ego_dist_coeffs=dist)
    bbox = forward_define_bbox(out2d)
    image_sizes = torch.as_tensor(misc.get(
        "image_size", [[2800, 2000]] + [[2800, 2000]] * (len(views) - 1)),
        dtype=torch.int32, device=device)
    valid = forward_valid(bbox, out2d["joints.right"], out2d["joints.left"],
                          image_sizes)

    cam_keys = ["joints.right", "joints.left"] + (
        ["joints.smplx"] if smplx_params is not None else [])
    payload = {
        "params": {k: _host(v) for k, v in params.items()},
        "2d": {k: _host(v) for k, v in out2d.items()
               if export_verts or "verts" not in k},
        "bbox": _host(bbox),
        **{k: _host(v) for k, v in valid.items()},
        "cam_coord": {key: _host(torch.stack([v[key] for v in views], dim=1))
                      for key in cam_keys},
    }
    os.makedirs(out_dir, exist_ok=True)
    out_p = os.path.join(out_dir, f"{sid}_{seq_name}.npy")
    np.save(out_p, payload)
    return out_p


def build_split(processed_dir: str, seq_names: List[str], setup: str,
                split: str, out_dir: str) -> str:
    """Concatenate processed sequences (``<processed_dir>/<name>.npy``)
    along the frame axis into ``<out_dir>/<setup>_<split>.npy``."""
    seqs = [np.load(os.path.join(processed_dir, f"{name}.npy"),
                    allow_pickle=True).item() for name in seq_names]
    merged = {}
    for key in seqs[0]:
        if isinstance(seqs[0][key], dict):
            merged[key] = {k: np.concatenate([s[key][k] for s in seqs])
                           for k in seqs[0][key]}
        else:
            merged[key] = np.concatenate([s[key] for s in seqs])
    os.makedirs(out_dir, exist_ok=True)
    out_p = os.path.join(out_dir, f"{setup}_{split}.npy")
    np.save(out_p, merged)
    return out_p
