"""Template meshes and interaction-field ground truth (port of
``hands_tpu/train/process_object.py``): root-normalised T-pose templates of
the hands and objects (joint + vertex token sequences for graph and
transformer decoders), and the ground-truth hand <-> object distance fields
from the batched kNN. The hand template runs ``mano_forward``, so K1
(``lbs_apply``) on CUDA tensors."""

from __future__ import annotations

import torch

from hands_tpu_torch.core.object_tensors import (ObjectTensors,
                                                 object_forward_7d)
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import knn as knnlib
from hands_tpu_torch.ops import mano as manolib

DIST_MIN, DIST_MAX = 0.0, 0.10  # metres, the reference's clamp


@torch.no_grad()
def prepare_mano_template(batch_size: int, model: manolib.ManoModel,
                          is_right: bool):
    """T-pose MANO, root-normalised: (joints + subsampled vertices tokens,
    joints + all vertices tokens), expanded to the batch."""
    dev = model.v_template.device
    out = manolib.mano_forward(
        model, torch.zeros((1, 10), device=dev),
        torch.zeros((1, 45), device=dev), torch.zeros((1, 3), device=dev))
    root = out.joints[:, :1]
    joints = out.joints - root
    verts = out.vertices - root
    verts_sub = manolib.decimate_verts(out.vertices, is_right) - root

    ref = torch.cat([joints, verts_sub], dim=1)
    ref_full = torch.cat([joints, verts], dim=1)
    return (ref.expand((batch_size,) + ref.shape[1:]),
            ref_full.expand((batch_size,) + ref_full.shape[1:]))


@torch.no_grad()
def prepare_object_template(batch_size: int, tensors: ObjectTensors,
                            obj_idx: torch.Tensor):
    """T-pose objects (no articulation or rotation), mm -> m, centred on
    the subsampled vertices: (v_sub, parts_sub_ids, v_full, mask)."""
    dev = tensors.v.device
    out = object_forward_7d(
        tensors,
        angles=torch.zeros((batch_size, 1), device=dev),
        global_orient=torch.zeros((batch_size, 3), device=dev),
        transl=None,
        obj_idx=obj_idx,
    )
    v_sub = out["v_sub"] / 1000.0
    v_full = out["v"] / 1000.0
    center = v_sub.mean(dim=1, keepdim=True)
    return (v_sub - center, out["parts_sub_ids"], v_full - center, out["mask"])


@torch.no_grad()
def prepare_interfield(targets: XDict, max_dist: float = DIST_MAX) -> XDict:
    """Ground-truth hand <-> object distance fields and closest-vertex
    indices: ``dist.ro``/``.lo`` per MANO vertex, ``dist.or``/``.ol`` per
    object vertex, clamped to [0, max_dist]."""
    out = XDict(targets)
    v_o = targets["object.v.cam"]
    v_len = targets["object.v_len"]
    for side in ("r", "l"):
        v_h = targets[f"mano.v3d.cam.{side}"]
        d_ho, i_ho = knnlib.compute_dist_mano_to_obj(
            v_h, v_o, v_len, DIST_MIN, max_dist)
        d_oh, i_oh = knnlib.compute_dist_obj_to_mano(
            v_h, v_o, v_len, DIST_MIN, max_dist)
        out[f"dist.{side}o"] = d_ho
        out[f"idx.{side}o"] = i_ho
        out[f"dist.o{side}"] = d_oh
        out[f"idx.o{side}"] = i_oh
    return out
