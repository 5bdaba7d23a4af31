"""HandOccNet (``handoccnet_light``): occlusion-robust hand reconstruction
(port of ``hands_tpu/models/handoccnet_light.py``).

An FPN over a leaky-ReLU ResNet-50 -> a CBAM spatial gate that splits the
map into primary (hand) and secondary (occluder) features -> FIT (the
feature-injecting transformer: sigmoid-gated cross-attention that injects
the secondary features into the primary ones) -> SET (the self-enhancing
transformer) -> an hourglass heatmap regressor, an encoder and a 6D MANO
regression head. Right and left crops are stacked along the batch for one
pass; KPE embeddings are added inside the FIT/SET blocks and after SET.

Maps are NHWC at every module boundary, as in the JAX model; convolutions
see NCHW views in ``channels_last`` format inside. Token and flatten orders
are the JAX model's: the 32 x 32 tokens run over (H, W), and the regressor
flattens its (2, 2, 256) map in (H, W, C) order into its first dense layer.

Numerics follow the Flax modules: parameters are f32 and cast to the compute
dtype per call; BatchNorm computes in f32 and rounds to the compute dtype
(momentum 0.99 of the old statistics in train mode); the blocks' LayerNorm
takes eps 1e-5; leaky ReLU has slope 0.01; the GELU is exact; the
attentions (1024 tokens, 4 heads of 64) are products with an f32 softmax,
and the injection gate sums a materialised 1024 x 1024 product as the JAX
model does. The regressor runs in f32 whatever the compute dtype. The
resizes are ``jax.image.resize``'s (``ops/resize.py``): the FPN's x2
top-down upsampling, and the crop to 256^2, antialiased where it shrinks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hands_tpu_torch.config import Config
from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.models import kpe
from hands_tpu_torch.models.backbones.resnet import BatchNorm, Conv
from hands_tpu_torch.models.backbones.vit import Dense, LayerNorm
from hands_tpu_torch.models.hands_light import GraspClassifier
from hands_tpu_torch.models.heads.mano_head import ManoBuffers, mano_head
from hands_tpu_torch.ops import mano as manolib
from hands_tpu_torch.ops.quant import serving_conv_cls
from hands_tpu_torch.ops.rasterizer import render_silhouette
from hands_tpu_torch.ops.resize import resize
from hands_tpu_torch.ops.vit_block import gelu

_F32 = torch.float32
SLOPE = 0.01  # leaky ReLU
MAP = 32  # side of the FIT/SET token grid: 256^2 input / 8


def leaky(x):
    return F.leaky_relu(x, SLOPE)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- backbone
class LeakyBottleneck(nn.Module):
    """ResNet bottleneck with leaky ReLUs; NCHW in and out."""

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=_F32, conv_cls: Callable = Conv, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = conv_cls(in_ch, filters, 1, 1, 0, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = conv_cls(filters, filters, 3, strides, 1, **kw)
        self.bn2 = BatchNorm(filters, **kw)
        self.conv3 = conv_cls(filters, filters * 4, 1, 1, 0, **kw)
        self.bn3 = BatchNorm(filters * 4, **kw)
        self.down_conv = self.bn_skip = None
        if strides != 1 or in_ch != filters * 4:
            self.down_conv = conv_cls(in_ch, filters * 4, 1, strides, 0, **kw)
            self.bn_skip = BatchNorm(filters * 4, **kw)

    def forward(self, x):
        y = leaky(self.bn1(self.conv1(x)))
        y = leaky(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.down_conv is not None:
            x = self.bn_skip(self.down_conv(x))
        return leaky(y + x)


class SpatialGate(nn.Module):
    """CBAM spatial gate: channel max and mean -> 7x7 conv -> BatchNorm ->
    sigmoid s; returns (x * s, x * (1 - s)), the hand and occluder split.
    NHWC in and out."""

    def __init__(self, dtype=_F32, device=None):
        super().__init__()
        self.spatial_conv = Conv(2, 1, 7, 1, 3, dtype=dtype, device=device)
        self.spatial_bn = BatchNorm(1, dtype=dtype, device=device)

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=-1, keepdim=True),
                            x.mean(dim=-1, keepdim=True)], dim=-1)
        s = self.spatial_bn(self.spatial_conv(_nchw(pooled)))
        s = _nhwc(torch.sigmoid(s))
        return x * s, x * (1.0 - s)


class FPN(nn.Module):
    """Leaky-ReLU ResNet-50 + top-down FPN to a 32x32x256 map, gate-split.
    ``quant_int8`` swaps the trunk's bottleneck convolutions for the W8A8
    serving convolution (inference only); stem, laterals and smoothing
    convolutions stay in the compute dtype."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self, dtype=_F32, quant_int8: bool = False, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv_stem = Conv(3, 64, 7, 2, 3, **kw)
        self.bn_stem = BatchNorm(64, **kw)
        conv_cls = serving_conv_cls(quant_int8)
        ch = 64
        for i, (filters, blocks, stride) in enumerate(self.STAGES):
            stage = nn.ModuleList()
            for j in range(blocks):
                stage.append(LeakyBottleneck(ch, filters,
                                             stride if j == 0 else 1,
                                             conv_cls=conv_cls, **kw))
                ch = filters * 4
            setattr(self, f"layer{i + 1}", stage)

        def conv(in_ch, k, pad=0):
            return Conv(in_ch, 256, k, 1, pad, use_bias=True, **kw)

        self.toplayer = conv(2048, 1)
        self.latlayer1 = conv(1024, 1)
        self.latlayer2 = conv(512, 1)
        self.latlayer3 = conv(256, 1)
        # smooth2 smooths p3, which nothing reads (the JAX model computes it
        # and XLA drops it): the parameter is kept, the convolution not run
        self.smooth2 = conv(256, 3, 1)
        self.smooth3 = conv(256, 3, 1)
        self.gate = SpatialGate(**kw)

    def forward(self, x):  # (B, 256, 256, 3)
        x = _nchw(x)
        c = F.max_pool2d(leaky(self.bn_stem(self.conv_stem(x))), 3, 2, 1)
        feats = []
        for i in range(4):
            for block in getattr(self, f"layer{i + 1}"):
                c = block(c)
            feats.append(c)
        c2, c3, c4, c5 = feats

        def up_add(top, lateral):
            # an exact x2: jax.image.resize's bilinear upsampling
            return F.interpolate(top, size=lateral.shape[-2:],
                                 mode="bilinear", align_corners=False,
                                 antialias=False) + lateral

        p5 = self.toplayer(c5)
        p4 = up_add(p5, self.latlayer1(c4))
        p3 = up_add(p4, self.latlayer2(c3))
        p2 = up_add(p3, self.latlayer3(c2))
        p2 = F.avg_pool2d(self.smooth3(p2), 2, 2)  # 64 -> 32
        return self.gate(_nhwc(p2))


# ------------------------------------------------------------- FIT / SET
def _tokens_1x1(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv`` with bias on (..., C) tokens, rounded as Flax's
    ``nn.Conv(dtype=...)``: the product in the dtype, then + bias."""
    w = conv.weight.flatten(1).to(conv.dtype)
    return F.linear(x.to(conv.dtype), w) + conv.bias.to(conv.dtype)


class GatedAttentionBlock(nn.Module):
    """One FIT/SET block: 1x1-conv projections with learned 32x32 q/k
    position maps (+ KPE), the attention, with ``injection`` a sigmoid gate
    from a second q/k pair, then a token MLP. NHWC in and out."""

    def __init__(self, dim: int = 256, num_heads: int = 4,
                 mlp_ratio: float = 4.0, injection: bool = True, dtype=_F32,
                 size: int = MAP, device=None):
        super().__init__()
        self.num_heads, self.injection, self.dtype = (num_heads, injection,
                                                      dtype)
        self.q_embedding = nn.Parameter(
            torch.empty(1, size, size, dim, device=device))
        self.k_embedding = nn.Parameter(
            torch.empty(1, size, size, dim, device=device))
        names = ["encode_value", "encode_query", "encode_key"]
        if injection:
            names += ["encode_query2", "encode_key2"]
        for name in names:
            setattr(self, name, Conv(dim, dim, 1, use_bias=True, dtype=dtype,
                                     device=device))
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden, dtype, device=device, param_dtype=_F32)
        self.fc2 = Dense(hidden, dim, dtype, device=device, param_dtype=_F32)

    def forward(self, query, key, kpe_emb=None):
        B, H, W, C = query.shape
        N, h = H * W, self.num_heads
        d = C // h
        scale = d**-0.5
        q_embed = query + self.q_embedding.to(query.dtype)
        k_embed = key + self.k_embedding.to(key.dtype)
        if kpe_emb is not None:
            kpe_map = kpe_emb.reshape(B, H, W, C).to(query.dtype)
            q_embed = q_embed + kpe_map
            k_embed = k_embed + kpe_map

        def heads(conv, z):  # (B, H, W, C) -> (B, heads, N, d)
            return _tokens_1x1(conv, z).reshape(B, N, h, d).transpose(1, 2)

        v = heads(self.encode_value, key)
        q = heads(self.encode_query, q_embed)
        k = heads(self.encode_key, k_embed)
        attn = torch.matmul(q * scale, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(query.dtype)
        if self.injection:
            q2 = heads(self.encode_query2, q_embed)
            k2 = heads(self.encode_key2, k_embed)
            gate = torch.matmul(q2 * scale, k2.transpose(-1, -2)).sum(-1)
            gate = torch.sigmoid(gate.float()).to(query.dtype)
            attn = attn * gate[..., None]
        out = torch.matmul(attn, v.to(attn.dtype)).transpose(1, 2)
        out = out.reshape(B, N, C)
        tokens = out if self.injection else query.reshape(B, N, C) + out
        y = gelu(self.fc1(self.norm2(tokens)), False)
        tokens = tokens + self.fc2(y)
        return tokens.reshape(B, H, W, C)


class InjectionTransformer(nn.Module):
    """FIT (``injection``) or SET: ``depth`` gated blocks; FIT then fuses the
    key map with the blocks' output (two 3x3 convs beside a 1x1)."""

    def __init__(self, depth: int = 2, injection: bool = True, dtype=_F32,
                 dim: int = 256, device=None):
        super().__init__()
        self.injection = injection
        self.blocks = nn.ModuleList([
            GatedAttentionBlock(dim, injection=injection, dtype=dtype,
                                device=device) for _ in range(depth)])
        if injection:
            kw = dict(use_bias=True, dtype=dtype, device=device)
            self.conv1a = Conv(2 * dim, 256, 3, 1, 1, **kw)
            self.conv1b = Conv(256, 256, 3, 1, 1, **kw)
            self.conv2 = Conv(2 * dim, 256, 1, **kw)

    def forward(self, query, key, kpe_emb=None):
        out = query
        for block in self.blocks:
            out = block(out, key, kpe_emb=kpe_emb)
        if self.injection:
            z = _nchw(torch.cat([key, out], dim=-1))
            a = self.conv1b(F.relu(self.conv1a(z)))
            out = _nhwc(a + self.conv2(z))
        return out


# -------------------------------------------------------------- regressor
class HGResidual(nn.Module):
    """Pre-activation residual of the hourglass; NCHW in and out."""

    def __init__(self, in_ch: int, channels: int, dtype=_F32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        half = channels // 2
        self.bn0 = BatchNorm(in_ch, **kw)
        self.conv0 = Conv(in_ch, half, 1, use_bias=True, **kw)
        self.bn1 = BatchNorm(half, **kw)
        self.conv1 = Conv(half, half, 3, 1, 1, use_bias=True, **kw)
        self.bn2 = BatchNorm(half, **kw)
        self.conv2 = Conv(half, channels, 1, use_bias=True, **kw)
        self.conv3 = (Conv(in_ch, channels, 1, use_bias=True, **kw)
                      if in_ch != channels else None)

    def forward(self, x):
        y = self.conv0(leaky(self.bn0(x)))
        y = self.conv1(leaky(self.bn1(y)))
        y = self.conv2(leaky(self.bn2(y)))
        if self.conv3 is not None:
            x = self.conv3(x)
        return x + y


class Hourglass(nn.Module):
    """Recursive hourglass, unrolled; its residuals keep the JAX scope names
    (``hg_up``, ``hg_low1``, ``hg_d_up``, ..., ``hg_d_d_d_mid``). NHWC in and
    out."""

    def __init__(self, depth: int = 4, channels: int = 256, dtype=_F32,
                 device=None):
        super().__init__()
        self.depth = depth
        names = []
        prefix = "hg"
        for n in range(depth, 0, -1):
            names += [f"{prefix}_up", f"{prefix}_low1", f"{prefix}_low3"]
            if n == 1:
                names.append(f"{prefix}_mid")
            prefix += "_d"
        self.res = nn.ModuleDict({
            name: HGResidual(channels, channels, dtype, device)
            for name in names})

    def forward(self, x):
        def hg(n, z, prefix):
            up1 = self.res[f"{prefix}_up"](z)
            low1 = self.res[f"{prefix}_low1"](F.max_pool2d(z, 2, 2))
            if n > 1:
                low2 = hg(n - 1, low1, prefix + "_d")
            else:
                low2 = self.res[f"{prefix}_mid"](low1)
            low3 = self.res[f"{prefix}_low3"](low2)
            return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

        return _nhwc(hg(self.depth, _nchw(x), "hg"))


class Regressor(nn.Module):
    """Hourglass heatmaps -> spatial-softmax 2D joints -> encoder -> MANO 6D
    regression, in f32. NHWC (B, 32, 32, 256) in; a dict of pose rotation
    matrices, shape, weak-perspective camera and 2D joints out."""

    def __init__(self, num_joints: int = 21, channels: int = 256,
                 device=None):
        super().__init__()
        kw = dict(use_bias=True, device=device)
        self.num_joints = num_joints
        self.hourglass = Hourglass(channels=channels, device=device)
        self.res = HGResidual(channels, 256, device=device)
        self.fc = Conv(256, 256, 1, **kw)
        self.fc_bn = BatchNorm(256, device=device)
        self.score = Conv(256, num_joints, 1, **kw)
        self.betas = nn.Parameter(torch.empty(num_joints, device=device))
        self.heatmap_conv = Conv(num_joints, 256, 1, **kw)
        self.encoding_conv = Conv(256, 256, 1, **kw)
        self.reg = nn.ModuleList([HGResidual(256, 256, device=device)
                                  for _ in range(8)])
        self.fc1 = Dense(1024, 1024, device=device)
        self.fc2 = Dense(1024, 512, device=device)
        self.pose_reg = Dense(512, 96, device=device)
        self.shape_reg = Dense(512, 10, device=device)
        self.cam_reg = Dense(512, 3, device=device)

    def forward(self, x):
        B, H, W, _ = x.shape
        J = self.num_joints
        y = self.res(_nchw(self.hourglass(x)))
        y = leaky(self.fc_bn(self.fc(y)))
        latents = self.score(y)  # (B, J, H, W)

        # spatial softmax with a learned temperature per joint
        flat = _nhwc(latents).reshape(B, H * W, J) * self.betas
        heat = torch.softmax(flat, dim=1)
        grid = (torch.arange(H, dtype=_F32, device=x.device) + 0.5) / H
        uu = grid.repeat(H)  # x along W
        vv = grid.repeat_interleave(W)
        joints2d = torch.stack([torch.einsum("bnj,n->bj", heat, uu),
                                torch.einsum("bnj,n->bj", heat, vv)], dim=-1)
        heatmaps = _nchw(heat.reshape(B, H, W, J))

        z = self.heatmap_conv(heatmaps) + self.encoding_conv(y)
        for i in range(4):
            z = self.reg[2 * i + 1](self.reg[2 * i](z))
            z = F.max_pool2d(z, 2, 2)
        feat = _nhwc(z).reshape(B, -1)  # (H, W, C) order, as the JAX model

        m = leaky(self.fc2(leaky(self.fc1(feat))))
        pose6d = self.pose_reg(m)
        return {
            "pose": rotlib.rot6d_to_matrix_hamer(pose6d.reshape(B, 16, 6)),
            "shape": self.shape_reg(m),
            "cam_t.wp": self.cam_reg(m),
            "joints2d_hm": joints2d,
        }


def to_input(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 256, 256, C): ``jax.image.resize`` bilinear
    (antialiased where the crop shrinks)."""
    return resize(img, 256, 256, "bilinear")


class HandOccNetNet(nn.Module):
    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else _F32)
        L = cfg.n_freq_pos_enc
        self.kpe_fc1 = self.kpe_fc2 = None
        if cfg.pos_enc is not None:
            in_dim = 4 * L if cfg.pos_enc == "dense_latent" else 20 * L
            self.kpe_fc1 = Dense(in_dim, 256, device=device)
            self.kpe_fc2 = Dense(256, 256, device=device)
        self.fpn = FPN(self.dtype, bool(cfg.get("quant_int8", False)),
                       device=device)
        self.fit = InjectionTransformer(injection=True, dtype=self.dtype,
                                        device=device)
        self.set = InjectionTransformer(injection=False, dtype=self.dtype,
                                        device=device)
        self.regressor = Regressor(device=device)
        self.grasp_classifier = (GraspClassifier(10 + 16 * 9, device=device)
                                 if cfg.use_grasp_loss else None)

    def _kpe(self, inputs: dict, B: int) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if self.kpe_fc1 is None:
            return None
        L = cfg.n_freq_pos_enc
        if cfg.pos_enc == "dense_latent":
            enc = torch.cat([
                kpe.dense_pos_enc(inputs[f"{s}_dense_angle"],
                                  inputs[f"{s}_dense_mask"], L, MAP)
                for s in ("r", "l")], dim=0)  # (2B, 32, 32, 4L)
        else:
            enc = torch.cat([torch.cat([
                kpe.center_pos_enc(inputs[f"{s}_center_angle"], L),
                kpe.corner_pos_enc(inputs[f"{s}_corner_angle"], L)], dim=-1)
                for s in ("r", "l")], dim=0)  # (2B, 20L)
        e = F.relu(self.kpe_fc2(F.relu(self.kpe_fc1(enc))))
        if cfg.pos_enc == "dense_latent":
            return e.reshape(2 * B, MAP * MAP, 256)
        return e[:, None, :].expand(2 * B, MAP * MAP, 256)

    def forward(self, inputs: dict) -> dict:
        dtype = self.dtype
        B = inputs["r_img"].shape[0]
        x = torch.cat([to_input(inputs["r_img"].to(dtype)),
                       to_input(inputs["l_img"].to(dtype))], dim=0)
        kpe_emb = self._kpe(inputs, B)
        p_feats, s_feats = self.fpn(x)
        feats = self.fit(s_feats, p_feats, kpe_emb=kpe_emb)
        feats = self.set(feats, feats, kpe_emb=kpe_emb)
        if kpe_emb is not None:
            feats = feats + kpe_emb.reshape(feats.shape).to(feats.dtype)
        out = self.regressor(feats.float())
        result = {}
        for side, sl in (("r", slice(None, B)), ("l", slice(B, None))):
            h = {k: v[sl] for k, v in out.items() if k != "joints2d_hm"}
            h["cam_t.wp.init"] = h["cam_t.wp"]
            result[f"hmr_{side}"] = h
            if self.grasp_classifier is not None:
                result[f"grasp_{side}"] = self.grasp_classifier(torch.cat(
                    [h["shape"], h["pose"].reshape(B, -1)], dim=-1))
        return result


class HandOccNetLightModel(nn.Module):
    """HandOccNet with MANO decoding: ``model(inputs, meta_info)`` -> the
    prediction XDict of the JAX ``HandOccNetLightModel`` (``mano.*``, and
    with the config's flags ``grasp.*`` and ``render.*``). Train mode
    (``model.train()``) normalises with the batch's statistics; the model
    has no dropout."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.net = HandOccNetNet(cfg, device=device)
        dev = device or "cpu"  # nn.Module's own default for device=None
        self.mano_r = ManoBuffers(manolib.load_mano(is_rhand=True, device=dev))
        self.mano_l = ManoBuffers(manolib.load_mano(is_rhand=False, device=dev))

    @f32_matmuls  # f32 convolutions and products stay f32 on the card
    def forward(self, inputs: dict, meta_info: dict,
                generator=None) -> XDict:
        """``generator`` is the train step's dropout generator; HandOccNet
        has no dropout and ignores it."""
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
