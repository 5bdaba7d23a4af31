"""MANO decode head (port of ``hands_tpu/models/heads/mano_head.py``):
rotmats + shape + weak-persp cam -> posed mesh, joints and normalised 2D
keypoints, under the ``mano.*{.r|.l}`` prediction keys."""

from __future__ import annotations

import torch
from torch import nn

from hands_tpu_torch.core import camera as camlib
from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.ops import mano as manolib


class ManoBuffers(nn.Module):
    """A MANO model's arrays as non-persistent buffers, so that they move
    with the module (``.to(device)``) and stay out of the state dict."""

    def __init__(self, model: manolib.ManoModel):
        super().__init__()
        for k, v in model._asdict().items():
            self.register_buffer(k, v, persistent=False)

    @property
    def model(self) -> manolib.ManoModel:
        return manolib.ManoModel(
            **{k: getattr(self, k) for k in manolib.ManoModel._fields})


def mano_head(
    model: manolib.ManoModel,
    rotmat: torch.Tensor,  # (B, 16, 3, 3)
    shape: torch.Tensor,  # (B, 10)
    cam: torch.Tensor,  # (B, 3) weak-perspective [s, tx, ty]
    K: torch.Tensor,  # (B, 3, 3)
    img_res: int,
    is_rhand: bool,
) -> XDict:
    """Decode MANO params to mesh/joints, place with the weak-persp camera,
    reproject to normalised 2D. Keys postfixed ``.r``/``.l``."""
    B = rotmat.shape[0]
    aa = rotlib.matrix_to_axis_angle(rotmat.reshape(-1, 3, 3)).reshape(B, 48)
    out = manolib.mano_forward(
        model, betas=shape, hand_pose=aa[:, 3:], global_orient=aa[:, :3])

    avg_focal = (K[:, 0, 0] + K[:, 1, 1]) / 2.0
    cam_t = camlib.weak_perspective_to_perspective(cam, avg_focal, img_res,
                                                   min_s=0.1)
    j3d_cam = out.joints + cam_t[:, None, :]
    v3d_cam = out.vertices + cam_t[:, None, :]
    j2d = camlib.project2d(K, j3d_cam)
    j2d_norm = camlib.normalize_kp2d(j2d, img_res)

    xd = XDict()
    xd["cam_t.wp"] = cam
    xd["cam_t"] = cam_t
    xd["joints3d"] = out.joints
    xd["vertices"] = out.vertices
    xd["j3d.cam"] = j3d_cam
    xd["v3d.cam"] = v3d_cam
    xd["j2d.norm"] = j2d_norm
    xd["beta"] = shape
    xd["pose"] = rotmat
    return xd.postfix(".r" if is_rhand else ".l")
