"""Ground-truth preparation inside the step (port of
``hands_tpu/train/process.py``: ``process_data_light``).

Runs under ``no_grad``: MANO forward kinematics of the ground-truth
parameters of both hands, the canonical -> camera translations and the
weak-perspective ground-truth camera, written into the ``targets`` keys the
loss reads.
"""

from __future__ import annotations

import torch

from hands_tpu_torch.core import camera as camlib
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import mano as manolib


@torch.no_grad()
def process_data_light(mano_r: manolib.ManoModel, mano_l: manolib.ManoModel,
                       inputs: XDict, targets: XDict, meta_info: XDict,
                       img_res: int):
    """Returns (inputs, targets with the GT-derived keys added, meta_info)."""
    K = meta_info["intrinsics"]
    out = XDict(targets)
    avg_focal = (K[:, 0, 0] + K[:, 1, 1]) / 2.0

    for model, suffix in ((mano_r, ".r"), (mano_l, ".l")):
        pose = targets["mano.pose" + suffix].detach()
        j3d_full = targets["mano.j3d.full" + suffix].detach()
        gt = manolib.mano_forward(
            model, betas=targets["mano.beta" + suffix].detach(),
            hand_pose=pose[:, 3:], global_orient=pose[:, :3])
        # canonical-space joints and vertices
        out["mano.joints3d" + suffix] = gt.joints
        out["mano.vertices" + suffix] = gt.vertices
        # translation canonical -> camera space (mean offset over joints)
        T0 = (j3d_full - gt.joints).mean(dim=1)
        out["mano.v3d.cam" + suffix] = gt.vertices + T0[:, None, :]
        out["mano.j3d.cam" + suffix] = j3d_full
        # GT camera translation: camera root minus canonical root
        cam_t = j3d_full[:, 0] - gt.joints[:, 0]
        out["mano.cam_t" + suffix] = cam_t
        out["mano.cam_t.wp" + suffix] = camlib.perspective_to_weak_perspective(
            cam_t, avg_focal, img_res)
    return inputs, out, meta_info
