"""WildHands (``hands_light``), the flagship model family (port of
``hands_tpu/models/hands_light.py``).

- a global-image backbone and one per-hand crop backbone shared by both
  hands, run once on the stacked [right; left] crop batch,
- KPE intrinsics encodings concatenated at the input or into the latent
  feature map (every ``pos_enc`` mode of the JAX model),
- per-hand iterative HMR heads -> MANO decode -> weak-perspective
  reprojection,
- grasp classifier, silhouette render and depth branches,
- the flip swap as a dense ``where`` over the batch.

Maps are NHWC at every module boundary, as in the JAX model; convolutions see
NCHW views inside. In eval mode BatchNorm runs on its running statistics and
dropout is the identity; in train mode (``model.train()``) BatchNorm takes the
batch's statistics and moves the running ones, and the HMR heads drop half of
their refinement activations with masks from the ``generator`` passed to
``forward``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hands_tpu_torch.config import Config
from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.models import kpe
from hands_tpu_torch.models.backbones.resnet import (BACKBONE_INFO, Conv,
                                                     resnet18, resnet50)
from hands_tpu_torch.models.backbones.vit import Dense
from hands_tpu_torch.models.heads.hmr import HandHMR
from hands_tpu_torch.models.heads.mano_head import ManoBuffers, mano_head
from hands_tpu_torch.ops import mano as manolib
from hands_tpu_torch.ops.rasterizer import render_silhouette

_POS_ENC_MODES = (
    None, "center", "corner", "center+corner", "dense", "center+corner_latent",
    "sinusoidal_cc", "dense_latent", "cam_conv", "pcl", "perspective_correction")


class FeatureConv(nn.Module):
    """Latent map (+ KPE channels) -> feature vector: 1x1 conv -> two valid
    3x3 convs -> flatten (in H, W, C order) -> dense. ``map_side`` is the
    side of the latent map: 7 for 224^2 crops."""

    def __init__(self, in_ch: int, feat_dim: int, dtype=torch.float32,
                 device=None, map_side: int = 7):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv(in_ch, 1024, 1, **kw)
        self.conv1 = Conv(1024, 512, 3, **kw)
        self.conv2 = Conv(512, 256, 3, **kw)
        side = map_side - 4  # two valid 3x3 convolutions
        self.dense = Dense(side * side * 256, feat_dim, dtype=dtype,
                           device=device,
                           param_dtype=torch.float32)

    def forward(self, x):  # (B, 7, 7, C)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv2(F.relu(self.conv1(F.relu(self.conv0(x))))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.dense(x))


class GraspClassifier(nn.Module):
    """9-way grasp-taxonomy classifier over (shape, pose[, global feature])."""

    def __init__(self, in_dim: int, device=None):
        super().__init__()
        dims = (in_dim, 1024, 512, 128, 9)
        self.layers = nn.ModuleList(
            [Dense(a, b, device=device) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class DepthHead(nn.Module):
    """Latent map + coordinate grid -> (B, img_res, img_res) depth."""

    _WIDTHS = (256, 256, 128, 128, 64, 32, 16, 1)
    _UP_AFTER = {1: 4, 3: 4, 5: 2}  # conv index -> upsampling factor

    def __init__(self, in_ch: int, device=None):
        super().__init__()
        chans = (in_ch + 2,) + self._WIDTHS
        self.convs = nn.ModuleList(
            [Conv(a, b, 3, padding=1, use_bias=True, device=device)
             for a, b in zip(chans[:-1], chans[1:])])

    def forward(self, x):  # (B, 7, 7, C)
        B, h, w, _ = x.shape
        # the row coordinate comes first, then the column coordinate
        row_g, col_g = torch.meshgrid(
            torch.linspace(-1, 1, h, device=x.device),
            torch.linspace(-1, 1, w, device=x.device), indexing="ij")
        grid = torch.stack([row_g, col_g], dim=-1)[None].expand(B, h, w, 2)
        x = torch.cat([x, grid.to(x.dtype)], dim=-1)
        for i, conv in enumerate(self.convs):
            x = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            if i < len(self.convs) - 1:
                x = F.relu(x)
            if i in self._UP_AFTER:
                f = self._UP_AFTER[i]
                x = kpe.resize_align_corners(x, x.shape[1] * f, x.shape[2] * f)
        return x[..., 0]


class RegressionHead(nn.Module):
    """Small MLP head (centre / corner regression)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList([Dense(in_dim, 512, device=device),
                                     Dense(512, 128, device=device),
                                     Dense(128, out_dim, device=device)])

    def forward(self, x):
        x = F.relu(self.layers[0](x))
        x = F.relu(self.layers[1](x))
        return self.layers[2](x)


def _build_backbone(name: str, in_ch: int, dtype, quant_int8: bool, device):
    if name == "resnet50":
        return resnet50(in_ch, dtype, quant_int8, device)
    if name == "resnet18":
        return resnet18(in_ch, dtype, quant_int8, device)
    if name == "vit_b_16":
        raise NotImplementedError(
            "backbone='vit_b_16' is not ported: ROADMAP queue 1 item 6")
    raise ValueError(f"unsupported backbone '{name}'")


class HandsLightNet(nn.Module):
    """Learnable part of WildHands: an input dict -> raw head outputs (before
    the flip swap and the MANO decode)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        if cfg.pos_enc not in _POS_ENC_MODES:
            raise ValueError(f"unknown pos_enc {cfg.pos_enc!r}")
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        feat_dim = BACKBONE_INFO[cfg.backbone]["n_output_channels"]
        L = cfg.n_freq_pos_enc
        pe = cfg.pos_enc
        q8 = bool(cfg.get("quant_int8", False))
        kw = dict(device=device)

        self.glb_backbone = None
        if cfg.use_glb_feat or cfg.no_crops:
            self.glb_backbone = _build_backbone(cfg.backbone, 3, self.dtype,
                                                q8, device)
        grasp_in = 10 + 16 * 9 + (
            feat_dim if cfg.use_glb_feat_w_grasp
            and self.glb_backbone is not None else 0)
        self.grasp_classifier = (GraspClassifier(grasp_in, **kw)
                                 if cfg.use_grasp_loss else None)
        if cfg.no_crops:
            self.head_r = HandHMR(feat_dim, **kw)
            self.head_l = HandHMR(feat_dim, **kw)
            return

        in_extra = {"center": 4 * L, "corner": 16 * L,
                    "center+corner": 20 * L, "dense": 4 * L}.get(pe, 0)
        if cfg.separate_hands:
            self.backbone_r = _build_backbone(cfg.backbone, 3 + in_extra,
                                              self.dtype, q8, device)
            self.backbone_l = _build_backbone(cfg.backbone, 3 + in_extra,
                                              self.dtype, q8, device)
        else:
            self.hand_backbone = _build_backbone(cfg.backbone, 3 + in_extra,
                                                 self.dtype, q8, device)
        latent = feat_dim + {"center+corner_latent": 20 * L,
                             "sinusoidal_cc": 20 * L, "dense_latent": 4 * L,
                             "cam_conv": 6}.get(pe, 0)
        self.depth_head = (DepthHead(latent, **kw) if cfg.use_depth_loss
                           else None)
        self.feature_conv = None
        if not cfg.tf_decoder:
            self.feature_conv = FeatureConv(latent, feat_dim, self.dtype,
                                            device, cfg.img_res_ds // 32)
        head_in = latent if cfg.tf_decoder else feat_dim
        self.head_r = HandHMR(feat_dim, head_in, tf_decoder=cfg.tf_decoder,
                              **kw)
        self.head_l = HandHMR(feat_dim, head_in, tf_decoder=cfg.tf_decoder,
                              **kw)
        self.center_head = self.corner_head = None
        if cfg.regress_center_corner:
            self.center_head = RegressionHead(head_in, 2, **kw)
            self.corner_head = RegressionHead(head_in, 8, **kw)

    def forward(self, inputs: dict, generator=None) -> dict:
        cfg = self.cfg
        dtype = self.dtype
        L = cfg.n_freq_pos_enc
        out: dict = {}

        # ---- global image branch
        glb_feat_map = None
        if self.glb_backbone is not None:
            glb_feat_map = self.glb_backbone(inputs["img"]).float()
            out["feat_vec"] = glb_feat_map.sum(dim=(1, 2))

        if cfg.no_crops:
            pooled = glb_feat_map.mean(dim=(1, 2))
            out["hmr_r"] = self.head_r(pooled, generator)
            out["hmr_l"] = self.head_l(pooled, generator)
            if self.grasp_classifier is not None:
                self._grasp_heads(out, pooled.shape[0])
            return out

        # ---- crop branch: encode KPE, stack right and left into one batch
        r_img = inputs["r_img"].to(dtype)
        l_img = inputs["l_img"].to(dtype)
        B, H, W, _ = r_img.shape

        def center_enc(side):
            return kpe.center_pos_enc(inputs[f"{side}_center_angle"], L)

        def corner_enc(side):
            return kpe.corner_pos_enc(inputs[f"{side}_corner_angle"], L)

        def dense_enc(side):
            return kpe.dense_pos_enc(inputs[f"{side}_dense_angle"],
                                     inputs[f"{side}_dense_mask"], L,
                                     cfg.img_res_ds)

        def input_concat(img, side):
            pe = cfg.pos_enc
            if pe == "dense":
                return torch.cat([img, dense_enc(side).to(dtype)], dim=-1)
            vec = {"center": [center_enc], "corner": [corner_enc],
                   "center+corner": [center_enc, corner_enc]}.get(pe)
            if vec is None:
                return img
            enc = torch.cat([fn(side) for fn in vec], dim=-1)
            return torch.cat(
                [img, kpe.broadcast_to_map(enc, H, W).to(dtype)], dim=-1)

        r_inp, l_inp = input_concat(r_img, "r"), input_concat(l_img, "l")
        if cfg.separate_hands:
            r_feat = self.backbone_r(r_inp).float()
            l_feat = self.backbone_l(l_inp).float()
        else:
            rl = self.hand_backbone(torch.cat([r_inp, l_inp], dim=0)).float()
            r_feat, l_feat = rl[:B], rl[B:]
        hf, wf = r_feat.shape[1:3]

        # ---- latent KPE concat. Only these branches add the global feature
        # map to the crop features; the other modes use it for feat_vec alone
        def latent_extra(side):
            pe = cfg.pos_enc
            if pe in ("center+corner_latent", "sinusoidal_cc"):
                return [kpe.broadcast_to_map(center_enc(side), hf, wf),
                        kpe.broadcast_to_map(corner_enc(side), hf, wf)]
            if pe == "dense_latent":
                # native -> img_res_ds inside the encoder, then -> map size
                return [kpe.resize_align_corners(dense_enc(side), hf, wf)]
            if pe == "cam_conv":
                enc = (inputs[f"{side}_dense_angle"]
                       * inputs[f"{side}_dense_mask"][..., None])
                enc = kpe.resize_align_corners(enc, cfg.img_res_ds,
                                               cfg.img_res_ds)
                return [kpe.resize_align_corners(enc, hf, wf)]
            return None

        def latent_concat(feat, side):
            extra = latent_extra(side)
            if extra is None:
                return feat
            if cfg.use_glb_feat:
                feat = feat + glb_feat_map
            return torch.cat([feat] + extra, dim=-1)

        r_feat, l_feat = latent_concat(r_feat, "r"), latent_concat(l_feat, "l")

        if self.depth_head is not None:
            out["depth_r"] = self.depth_head(r_feat)
            out["depth_l"] = self.depth_head(l_feat)

        # ---- latent maps -> vectors; with tf_decoder the heads cross-attend
        # to the maps directly
        if cfg.tf_decoder:
            r_vec, l_vec = r_feat, l_feat
        else:
            rl_vec = self.feature_conv(torch.cat([r_feat, l_feat], dim=0))
            r_vec, l_vec = rl_vec[:B], rl_vec[B:]
        out["hmr_r"] = self.head_r(r_vec, generator)
        out["hmr_l"] = self.head_l(l_vec, generator)

        if self.grasp_classifier is not None:
            self._grasp_heads(out, B)
        if self.center_head is not None:
            out["center_r"] = self.center_head(r_vec)
            out["center_l"] = self.center_head(l_vec)
            out["corner_r"] = self.corner_head(r_vec)
            out["corner_l"] = self.corner_head(l_vec)
        return out

    def _grasp_heads(self, out: dict, B: int) -> None:
        """One grasp classifier over both hands' head outputs; the global
        feature joins only where the global branch exists."""
        cfg = self.cfg

        def grasp_in(h):
            x = [h["shape"], h["pose"].reshape(B, -1)]
            if cfg.use_glb_feat_w_grasp and "feat_vec" in out:
                x.append(out["feat_vec"])
            return torch.cat(x, dim=-1)

        out["grasp_r"] = self.grasp_classifier(grasp_in(out["hmr_r"]))
        out["grasp_l"] = self.grasp_classifier(grasp_in(out["hmr_l"]))


# --------------------------------------------------------------- flip swap
def _apply_flip_swap(hmr_r: dict, hmr_l: dict, is_flipped: torch.Tensor):
    """Horizontally flipped samples predict the mirrored opposite hand: swap
    the right and left head outputs and mirror poses and translations, as a
    dense ``where`` over the batch."""
    flip = is_flipped.to(torch.bool)

    def mirror_pose(rotmat):
        B = rotmat.shape[0]
        aa = rotlib.matrix_to_axis_angle(rotmat.reshape(-1, 3, 3)).reshape(B, -1)
        return rotlib.axis_angle_to_matrix(
            rotlib.flip_axis_angle(aa).reshape(B, -1, 3))

    def mirror_t(t):
        return t * torch.tensor([1.0, -1.0, 1.0], dtype=t.dtype,
                                device=t.device)

    def swap(a, b, fn=lambda x: x):
        sel = flip.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(sel, fn(b), a), torch.where(sel, fn(a), b)

    out_r, out_l = dict(hmr_r), dict(hmr_l)
    for key, fn in (("cam_t.wp", mirror_t), ("cam_t.wp.init", mirror_t),
                    ("pose", mirror_pose), ("shape", lambda x: x)):
        out_r[key], out_l[key] = swap(hmr_r[key], hmr_l[key], fn)
    return out_r, out_l


def _rotate_global_orient(pose: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """pose (B, 16, 3, 3) with joint 0 replaced by ``R @ pose[:, 0]``."""
    return torch.cat([(R @ pose[:, 0])[:, None], pose[:, 1:]], dim=1)


def postprocess_hmr(cfg: Config, inputs: dict, meta_info: dict, hmr_r: dict,
                    hmr_l: dict):
    """Per-sample fixes of the head outputs, in this order: the pcl
    virtual-camera rotation, the flip swap, then the perspective-correction
    rotation of the global orientation (on the poses after the swap)."""
    hmr_r, hmr_l = dict(hmr_r), dict(hmr_l)

    # pcl: the crops were resampled by a virtual camera; map the predicted
    # global orientation back with R_virt2orig
    if cfg.pos_enc == "pcl":
        for hmr, key in ((hmr_r, "r_rot"), (hmr_l, "l_rot")):
            hmr["pose"] = _rotate_global_orient(hmr["pose"], inputs[key])

    is_flipped = meta_info.get("is_flipped")
    if is_flipped is not None:
        hmr_r, hmr_l = _apply_flip_swap(hmr_r, hmr_l, is_flipped)

    if cfg.pos_enc == "perspective_correction":
        for hmr, key in ((hmr_r, "r_center_angle"), (hmr_l, "l_center_angle")):
            ang = inputs[key]
            euler = torch.cat([-ang, torch.zeros_like(ang[:, :1])], dim=-1)
            R = rotlib.euler_angles_to_matrix(euler, "XYZ")
            hmr["pose"] = _rotate_global_orient(hmr["pose"], R)
    return hmr_r, hmr_l


class HandsLightModel(nn.Module):
    """WildHands with MANO decoding: ``model(inputs, meta_info)`` -> the
    prediction XDict of the JAX ``HandsLightModel`` (``mano.*``, and with the
    config's flags ``grasp.*``, ``render.*``, ``depth.*``, ``center.*``,
    ``corner.*``, ``feat_vec``)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.net = HandsLightNet(cfg, device=device)
        dev = device or "cpu"  # nn.Module's own default for device=None
        self.mano_r = ManoBuffers(manolib.load_mano(is_rhand=True, device=dev))
        self.mano_l = ManoBuffers(manolib.load_mano(is_rhand=False, device=dev))

    @f32_matmuls  # f32 convolutions and products stay f32 on the card
    def forward(self, inputs: dict, meta_info: dict,
                generator=None) -> XDict:
        """``generator``: the ``torch.Generator`` of the dropout masks, on
        the model's device; needed in train mode only."""
        cfg = self.cfg
        net_out = self.net(inputs, generator)
        hmr_r, hmr_l = postprocess_hmr(cfg, inputs, meta_info,
                                       net_out["hmr_r"], net_out["hmr_l"])
        K = meta_info["intrinsics"]
        mano_out_r = mano_head(self.mano_r.model, hmr_r["pose"], hmr_r["shape"],
                               hmr_r["cam_t.wp"], K, cfg.img_res, is_rhand=True)
        mano_out_l = mano_head(self.mano_l.model, hmr_l["pose"], hmr_l["shape"],
                               hmr_l["cam_t.wp"], K, cfg.img_res,
                               is_rhand=False)
        mano_out_r["cam_t.wp.init.r"] = hmr_r["cam_t.wp.init"]
        mano_out_l["cam_t.wp.init.l"] = hmr_l["cam_t.wp.init"]

        pred = XDict()
        pred.merge(mano_out_r.prefix("mano."))
        pred.merge(mano_out_l.prefix("mano."))
        if cfg.use_grasp_loss:
            pred["grasp.r"] = net_out["grasp_r"]
            pred["grasp.l"] = net_out["grasp_l"]
        if cfg.use_render_seg_loss:
            pred["render.r"] = render_silhouette(
                pred["mano.v3d.cam.r"], self.mano_r.faces, K, cfg.img_res)
            pred["render.l"] = render_silhouette(
                pred["mano.v3d.cam.l"], self.mano_l.faces, K, cfg.img_res)
        if cfg.use_depth_loss:
            pred["depth.r"] = net_out["depth_r"]
            pred["depth.l"] = net_out["depth_l"]
        if cfg.regress_center_corner:
            for k in ("center", "corner"):
                pred[f"{k}.r"] = net_out[f"{k}_r"]
                pred[f"{k}.l"] = net_out[f"{k}_l"]
        if "feat_vec" in net_out:
            pred["feat_vec"] = net_out["feat_vec"]
        return pred
