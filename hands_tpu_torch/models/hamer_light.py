"""HaMeR (``hamer_light``): ViT backbone + transformer-decoder MANO head
(port of ``hands_tpu/models/hamer_light.py``).

Right and left crops are stacked along the batch and run through the ViT
once (the 224^2 crop resized to 256^2, then centre-cropped to 256x192); the
center+corner KPE embeddings are MLP-encoded and added both to the patch
tokens and to the conditioning features; a single-query cross-attention
decoder reads out MANO parameters, decoded per side with that side's MANO.

Train mode is ``model.train()``: the int8 and calibration sub-paths of the
backbone go off, and a ViT-H without the fused block recomputes each block in
the backward pass. The model has neither BatchNorm nor dropout, so nothing
else changes. ``param_dtype=torch.float32`` keeps f32 master parameters under
bf16 compute (what ``train/state.py`` asks for); without it a bf16 model
stores its backbone weights in bf16, for serving.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hands_tpu_torch.config import Config
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.models import kpe
from hands_tpu_torch.models.backbones.vit import VIT_CONFIGS, Dense, ViTBackbone
from hands_tpu_torch.models.hands_light import GraspClassifier
from hands_tpu_torch.models.heads.hamer_head import ManoTransformerDecoderHead
from hands_tpu_torch.models.heads.mano_head import ManoBuffers, mano_head
from hands_tpu_torch.ops import mano as manolib
from hands_tpu_torch.ops.rasterizer import render_silhouette


class KpeTokenEmbed(nn.Module):
    """center+corner angles -> one embedding broadcast over the tokens
    (2-layer ReLU MLP over the sinusoidal encodings)."""

    def __init__(self, feat_dim: int, n_freq: int, n_tokens: int, device=None):
        super().__init__()
        self.n_freq = n_freq
        self.n_tokens = n_tokens
        self.fc1 = Dense(4 * n_freq + 16 * n_freq, feat_dim, device=device)
        self.fc2 = Dense(feat_dim, feat_dim, device=device)

    def forward(self, center_angle, corner_angle):
        enc = torch.cat([kpe.center_pos_enc(center_angle, self.n_freq),
                         kpe.corner_pos_enc(corner_angle, self.n_freq)], -1)
        x = F.relu(self.fc2(F.relu(self.fc1(enc))))
        return x[:, None, :].expand(x.shape[0], self.n_tokens, x.shape[-1])


def to_vit_input(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 256, 192, C): bilinear resize to 256^2 (half-pixel
    centres, no antialiasing: the JAX resize when upsampling), then crop 32
    px off each side of the width."""
    x = F.interpolate(img.permute(0, 3, 1, 2), size=(256, 256),
                      mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)[:, :, 32:-32, :]


class HamerNet(nn.Module):
    def __init__(self, cfg: Config, vit_variant: str = "h", device=None,
                 param_dtype=None):
        super().__init__()
        if cfg.pos_enc not in (None, "center+corner_latent"):
            raise NotImplementedError(
                f"pos_enc={cfg.pos_enc!r} is not ported for HaMeR (the dense "
                f"token embedding): ROADMAP queue 1 item 6")
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        embed_dim = VIT_CONFIGS[vit_variant]["embed_dim"]
        self.kpe = None
        if cfg.pos_enc is not None:
            self.kpe = KpeTokenEmbed(embed_dim, cfg.n_freq_pos_enc,
                                     n_tokens=(256 // 16) * (192 // 16),
                                     device=device)
        # int8 and calibration are inference only: the backbone turns them
        # off in train mode. The fused block rematerialises by construction,
        # so only the plain ViT-H checkpoints its blocks.
        fused_block = (bool(cfg.get("fused_block", False))
                       and self.dtype == torch.bfloat16)
        self.backbone = ViTBackbone(
            variant=vit_variant, dtype=self.dtype, param_dtype=param_dtype,
            use_checkpoint=vit_variant == "h" and not fused_block,
            fused_block=fused_block, device=device,
            fast_gelu=bool(cfg.get("fast_gelu", False)),
            quant_int8=bool(cfg.get("quant_int8", False)),
            quant_static=bool(cfg.get("quant_int8_static", False)),
            quant_calibrate=bool(cfg.get("quant_calibrate", False)))
        self.mano_head = ManoTransformerDecoderHead(context_dim=embed_dim,
                                                    device=device)
        self.grasp_classifier = (
            GraspClassifier(10 + 16 * 9, device=device)
            if cfg.use_grasp_loss else None)

    def forward(self, inputs: dict) -> dict:
        r_img = inputs["r_img"].to(self.dtype)
        l_img = inputs["l_img"].to(self.dtype)
        B = r_img.shape[0]
        x = torch.cat([to_vit_input(r_img), to_vit_input(l_img)], dim=0)

        kpe_emb = None
        if self.kpe is not None:
            kpe_emb = torch.cat([
                self.kpe(inputs["r_center_angle"], inputs["r_corner_angle"]),
                self.kpe(inputs["l_center_angle"], inputs["l_corner_angle"]),
            ], dim=0)

        feat = self.backbone(x, kpe_emb=kpe_emb).float()  # (2B, 16, 12, C)
        if kpe_emb is not None:
            # KPE is added again to the conditioning features
            h, w = feat.shape[1:3]
            feat = feat + kpe_emb.reshape(2 * B, h, w, -1)
        out = self.mano_head(feat)
        result = {
            side: {
                "pose": out["pose"][sl],
                "shape": out["shape"][sl],
                "cam_t.wp": out["cam_t.wp"][sl],
                "cam_t.wp.init": out["cam_t.wp"][sl],
            }
            for side, sl in (("hmr_r", slice(None, B)),
                             ("hmr_l", slice(B, None)))
        }
        if self.grasp_classifier is not None:
            for side in ("r", "l"):
                h = result[f"hmr_{side}"]
                result[f"grasp_{side}"] = self.grasp_classifier(torch.cat(
                    [h["shape"], h["pose"].reshape(B, -1)], dim=-1))
        return result


class HamerLightModel(nn.Module):
    """HaMeR with MANO decoding: ``model(inputs, meta_info)`` -> the
    ``mano.*`` prediction XDict of the JAX ``HamerLightModel``."""

    def __init__(self, cfg: Config, vit_variant: str = "h", device=None,
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.net = HamerNet(cfg, vit_variant=vit_variant, device=device,
                            param_dtype=param_dtype)
        dev = device or "cpu"  # nn.Module's own default for device=None
        self.mano_r = ManoBuffers(manolib.load_mano(is_rhand=True, device=dev))
        self.mano_l = ManoBuffers(manolib.load_mano(is_rhand=False, device=dev))

    def forward(self, inputs: dict, meta_info: dict,
                generator=None) -> XDict:
        """``generator`` is the train step's dropout generator; HaMeR has no
        dropout and ignores it."""
        cfg = self.cfg
        net_out = self.net(inputs)
        K = meta_info["intrinsics"]
        hmr_r, hmr_l = net_out["hmr_r"], net_out["hmr_l"]
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
        return pred
