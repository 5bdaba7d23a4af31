"""ARCTIC's articulated objects (port of ``hands_tpu/core/object_tensors.py``).

The 11 two-part objects articulate about a z-axis hinge;
:func:`object_forward_7d` applies the articulation (top part only), the
global rotation and the translation to the padded vertices, subsampled
vertices, 3D box corners and keypoints. The ragged meshes are padded to one
length with a mask.

The meshes come from ARCTIC's ``meta/object_vtemplates`` under ``$DATA_DIR``
when present (a built-in OBJ parser), else from the same deterministic
synthetic set as the JAX package (``RandomState(7)``, array for array).
"""

from __future__ import annotations

import functools
import json
import os
from typing import List, NamedTuple

import numpy as np
import torch

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.core.xdict import XDict

OBJECTS = [
    "capsulemachine", "box", "ketchup", "laptop", "microwave", "mixer",
    "notebook", "espressomachine", "waffleiron", "scissors", "phone",
]

Z_AXIS = np.asarray([0.0, 0.0, -1.0], np.float32)


def parse_obj(path: str):
    """Minimal wavefront OBJ parser: vertices + triangle faces."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


class ObjectTensors(NamedTuple):
    """Padded per-object tensors, stacked over the 11 objects."""

    v: torch.Tensor  # (O, Vmax, 3) padded template vertices (mm)
    mask: torch.Tensor  # (O, Vmax) valid-vertex mask
    v_len: torch.Tensor  # (O,)
    v_sub: torch.Tensor  # (O, S, 3) subsampled verts
    parts_ids: torch.Tensor  # (O, Vmax) 1=top (articulated) 2=bottom
    parts_sub_ids: torch.Tensor  # (O, S)
    f: torch.Tensor  # (O, Fmax, 3) padded faces
    f_len: torch.Tensor  # (O,)
    bbox_top: torch.Tensor  # (O, 8, 3)
    bbox_bottom: torch.Tensor  # (O, 8, 3)
    kp_top: torch.Tensor  # (O, 16, 3)
    kp_bottom: torch.Tensor  # (O, 16, 3)
    diameter: torch.Tensor  # (O,)


def _synthetic_object(rng: np.random.RandomState, n_v: int):
    """Two-part box-ish object: the top half articulates about z."""
    v = rng.randn(n_v, 3).astype(np.float32) * 40.0  # mm scale
    parts = np.where(v[:, 2] > 0, 1, 2).astype(np.int32)  # 1=top, 2=bottom
    f = rng.randint(0, n_v, (2 * n_v, 3)).astype(np.int32)
    return v, parts, f


@functools.lru_cache(maxsize=2)
def _object_arrays(n_sub: int, data_dir: str) -> dict:
    """The padded numpy arrays of :class:`ObjectTensors`."""
    base = os.path.join(
        data_dir, "arctic/data/arctic_data/data/meta/object_vtemplates")
    rng = np.random.RandomState(7)
    vs, parts, fs = [], [], []
    for i, name in enumerate(OBJECTS):
        obj_dir = os.path.join(base, name)
        if data_dir and os.path.isdir(obj_dir):
            v, f = parse_obj(os.path.join(obj_dir, "mesh.obj"))
            try:
                with open(os.path.join(obj_dir, "parts.json")) as fp:
                    p = np.asarray(json.load(fp), np.int32)
                    p = p + 1 if p.min() == 0 else p
            except (OSError, ValueError):
                p = np.full(len(v), 2, np.int32)
        else:
            v, p, f = _synthetic_object(rng, 2800 + i * 97)
        vs.append(v)
        parts.append(p)
        fs.append(f)

    v_max = max(len(v) for v in vs)
    f_max = max(len(f) for f in fs)
    O = len(OBJECTS)
    a = dict(
        v=np.zeros((O, v_max, 3), np.float32),
        mask=np.zeros((O, v_max), np.float32),
        v_len=np.zeros(O, np.int32),
        v_sub=np.zeros((O, n_sub, 3), np.float32),
        parts_ids=np.zeros((O, v_max), np.int32),
        parts_sub_ids=np.zeros((O, n_sub), np.int32),
        f=np.zeros((O, f_max, 3), np.int32),
        f_len=np.zeros(O, np.int32),
        bbox_top=np.zeros((O, 8, 3), np.float32),
        bbox_bottom=np.zeros((O, 8, 3), np.float32),
        kp_top=np.zeros((O, 16, 3), np.float32),
        kp_bottom=np.zeros((O, 16, 3), np.float32),
        diameter=np.zeros(O, np.float32),
    )

    def corners(lo, hi):
        return np.asarray(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])], np.float32)

    for i, (v, p, f) in enumerate(zip(vs, parts, fs)):
        n = len(v)
        a["v"][i, :n] = v
        a["mask"][i, :n] = 1
        a["parts_ids"][i, :n] = p
        a["f"][i, : len(f)] = f
        a["v_len"][i] = n
        a["f_len"][i] = len(f)
        sub_idx = np.linspace(0, n - 1, n_sub).astype(np.int64)
        a["v_sub"][i] = v[sub_idx]
        a["parts_sub_ids"][i] = p[sub_idx]
        for part, bb, kp in ((1, a["bbox_top"], a["kp_top"]),
                             (2, a["bbox_bottom"], a["kp_bottom"])):
            pv = v[p == part]
            if len(pv) == 0:
                pv = v
            bb[i] = corners(pv.min(0), pv.max(0))
            kp_idx = np.linspace(0, len(pv) - 1, 16).astype(np.int64)
            kp[i] = pv[kp_idx]
        a["diameter"][i] = float(np.linalg.norm(v.max(0) - v.min(0)))
    return a


def build_object_tensors(n_sub: int = 600, device="cpu") -> ObjectTensors:
    """The object set on ``device``: ARCTIC's meshes if ``$DATA_DIR`` holds
    them, else the synthetic set."""
    arrays = _object_arrays(n_sub, os.environ.get("DATA_DIR", ""))
    return ObjectTensors(**{k: torch.from_numpy(v).to(device)
                            for k, v in arrays.items()})


def _quat_apply(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate points (B, N, 3) by unit quaternions (B, 4) [w, x, y, z]."""
    w, xyz = q[:, :1], q[:, 1:]
    xyz = xyz[:, None, :].expand(pts.shape)
    t = 2.0 * torch.linalg.cross(xyz, pts, dim=-1)
    return pts + w[:, :, None] * t + torch.linalg.cross(xyz, t, dim=-1)


@f32_matmuls
def object_forward_7d(
    tensors: ObjectTensors,
    angles: torch.Tensor,  # (B, 1) articulation radians
    global_orient: torch.Tensor,  # (B, 3) axis-angle
    transl: torch.Tensor | None,  # (B, 3), in the template's mm
    obj_idx: torch.Tensor,  # (B,) index into OBJECTS
) -> XDict:
    """Batched articulated-object FK: padded vertices (mm, as the templates;
    callers convert), subsampled vertices, 16 + 16 keypoints, 8 + 8 box
    corners, masks, lengths and part ids."""
    obj_idx = obj_idx.long()
    out = XDict()
    out["diameter"] = tensors.diameter[obj_idx]
    out["v_len"] = tensors.v_len[obj_idx]
    out["f"] = tensors.f[obj_idx]
    out["f_len"] = tensors.f_len[obj_idx]
    out["mask"] = tensors.mask[obj_idx]
    out["parts_ids"] = tensors.parts_ids[obj_idx]
    out["parts_sub_ids"] = tensors.parts_sub_ids[obj_idx]

    z_axis = torch.from_numpy(Z_AXIS).to(angles.device)
    quat_arti = rotlib.axis_angle_to_quaternion(
        z_axis[None, :] * angles.reshape(-1, 1))
    quat_global = rotlib.axis_angle_to_quaternion(global_orient.reshape(-1, 3))

    def place(pts):
        pts = _quat_apply(quat_global, pts)
        if transl is not None:
            pts = pts + transl[:, None, :]
        return pts

    def articulate_then_place(pts, is_top=None):
        top = _quat_apply(quat_arti, pts)
        if is_top is not None:
            top = torch.where(is_top[..., None] == 1, top, pts)
        return place(top)

    out["v"] = articulate_then_place(tensors.v[obj_idx], out["parts_ids"])
    out["v_sub"] = articulate_then_place(tensors.v_sub[obj_idx],
                                         out["parts_sub_ids"])
    bbox_top = articulate_then_place(tensors.bbox_top[obj_idx])
    kp_top = articulate_then_place(tensors.kp_top[obj_idx])
    bbox_bottom = place(tensors.bbox_bottom[obj_idx])
    kp_bottom = place(tensors.kp_bottom[obj_idx])
    out["bbox3d"] = torch.cat([bbox_top, bbox_bottom], dim=1)
    out["kp3d"] = torch.cat([kp_top, kp_bottom], dim=1)
    return out


def object_names_to_idx(names: List[str]) -> np.ndarray:
    return np.asarray([OBJECTS.index(n) for n in names])
