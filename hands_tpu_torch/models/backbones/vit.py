"""ViT backbones for HaMeR and the ``vit_b_16`` WildHands variant (port of
``hands_tpu/models/backbones/vit.py``).

ViTPose-style, no class token: patchify -> + pos -> [+ KPE tokens] -> blocks
-> LayerNorm -> (B, H/16, W/16, C) NHWC feature map. The JAX package's
scan-stacked blocks become an ``nn.ModuleList``. :class:`VitB16Spatial` puts
a conv adapter behind ViT-B/16 for WildHands: (B, 224, 224, C_in) ->
(B, 7, 7, 2048), the map a ResNet-50 gives.

Dtypes follow the Flax modules: LayerNorms compute and return f32, and every
dense product is rounded to the compute dtype before its bias is added (Flax
``nn.Dense``'s rounding point). Parameters are cast to the compute dtype per
call, as Flax casts them. A serving backbone stores its matmul weights and
biases in the compute dtype already (in bf16 the values that cast produces);
``param_dtype=torch.float32`` keeps f32 master parameters under bf16 compute,
which is what an optimiser needs.
With ``fused_block`` and bf16 a block runs the hand-written kernels of
``ops/vit_block.py`` (bf16, through ``vit_block_fused_trainable``, so it can
be trained) or ``ops/vit_block_int8.py`` (``quant_int8``, ``quant_static``);
with ``fused_attn`` the plain block's attention runs the kernel of
``ops/attention.py``; otherwise the plain modules below. Modules start in
eval mode (the JAX modules' ``train=False`` default). In train mode
(``module.train()``) the int8 and calibration sub-paths are off, as the JAX
model turns them off under ``train=True``, and ``use_checkpoint`` recomputes
each plain block in the backward pass.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hands_tpu_torch.models.backbones.resnet import BatchNorm, Conv
from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops.attention import mha_fused
from hands_tpu_torch.ops.vit_block import (block_params, gelu, layernorm_f32,
                                           vit_block_fused_trainable)
from hands_tpu_torch.ops.vit_block_int8 import (vit_block_fused_int8,
                                                vit_block_fused_int8_static)

PATCH = 16
IMG_HW = (256, 192)  # HaMeR's ViT input: 16 x 12 patches
VIT_CONFIGS = {
    "b16": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0),
    "h": dict(embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4.0),
    # a small variant for tests
    "tiny": dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=2.0),
}
QUANT_POINTS = ("qkv", "proj", "mlp1", "mlp2")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fast variance, f32 in and out."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layernorm_f32(x.float(), self.scale, self.bias, self.eps)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: ``x . W`` in ``dtype``, rounded, then
    ``+ b`` in ``dtype``. The weight is stored (out, in), as ``nn.Linear``,
    in ``param_dtype`` (``dtype`` unless given; the int8 blocks keep f32
    values to quantise from) and cast to ``dtype`` per call, as Flax does."""

    def __init__(self, in_f: int, out_f: int, dtype=torch.float32,
                 use_bias: bool = True, device=None, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        pd = param_dtype or dtype
        self.weight = nn.Parameter(
            torch.empty(out_f, in_f, dtype=pd, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_f, dtype=pd, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Int8Dense(nn.Module):
    """Drop-in ``Dense`` with W8A8 dynamic quantisation for inference (port
    of the Flax ``Int8Dense``; plain PyTorch, it is no kernel). Weights:
    symmetric per-output-channel int8, quantised from the f32 parameters on
    every call; activations: symmetric per-tensor dynamic int8. Same
    parameter names and shapes as ``Dense``."""

    def __init__(self, in_f: int, out_f: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype  # output dtype (the block compute dtype)
        self.weight = nn.Parameter(torch.empty(out_f, in_f, device=device))
        self.bias = nn.Parameter(torch.zeros(out_f, device=device))
        self.eval()

    def forward(self, x):
        if self.training:  # int8 is inference only: the plain Dense
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
            return y + self.bias.to(self.dtype)
        w_q, w_scale = quant.quantize_weight_int8(self.weight)
        xf = x.float()
        x_scale = quant.scale_from_amax(torch.amax(torch.abs(xf)))
        x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
        y = quant.int_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q)
        y = y.reshape(*x.shape[:-1], -1)
        return (y.float() * (x_scale * w_scale) + self.bias).to(self.dtype)


def _dense(in_f, out_f, dtype, quant_int8: bool, device, param_dtype=None):
    if quant_int8:
        return Int8Dense(in_f, out_f, dtype, device=device)
    return Dense(in_f, out_f, dtype, device=device, param_dtype=param_dtype)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, device=None,
                 fast_gelu: bool = False, quant_int8: bool = False,
                 param_dtype=None):
        super().__init__()
        self.fast_gelu = fast_gelu
        self.fc1 = _dense(dim, hidden, dtype, quant_int8, device, param_dtype)
        self.fc2 = _dense(hidden, dim, dtype, quant_int8, device, param_dtype)

    def forward(self, x, tap: Optional[Callable] = None):
        x = gelu(self.fc1(x), self.fast_gelu)
        if tap is not None:  # calibration point: MLP second-dense input
            tap(x)
        return self.fc2(x)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype, device=None,
                 quant_int8: bool = False, fused_attn: bool = False,
                 param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.fused_attn = fused_attn
        self.qkv = _dense(dim, 3 * dim, dtype, quant_int8, device, param_dtype)
        self.proj = _dense(dim, dim, dtype, quant_int8, device, param_dtype)

    def forward(self, x, tap: Optional[Callable] = None):
        # x: the f32 LayerNorm output. As in the Flax module, logits come
        # out of the product in the compute dtype, the softmax runs in f32
        # and the probabilities keep x's dtype, so p.v promotes v to f32.
        B, N, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).view(B, N, 3, H, D)
        if self.fused_attn:
            # one kernel per forward: no (B, H, N, N) tensor in device memory
            out = mha_fused(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], D**-0.5)
            out = out.reshape(B, N, C)
        else:
            q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, H, N, D) each
            scale = torch.tensor(D**-0.5, dtype=q.dtype, device=q.device)
            attn = torch.matmul(q * scale, k.transpose(-1, -2))
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.matmul(attn, v.to(attn.dtype))
            out = out.permute(0, 2, 1, 3).reshape(B, N, C)
        if tap is not None:  # calibration point: proj input
            tap(out)
        return self.proj(out)


class Block(nn.Module):
    """One pre-LN transformer block, routed as the Flax ``Block``:

    - ``fused_block`` and bf16 (and not calibrating): the hand-written
      kernels: the static W8A8 block with ``quant_int8`` and ``quant_static``,
      the dynamic W8A8 block with ``quant_int8``, else the bf16 block;
    - otherwise the plain modules, with ``Int8Dense`` under ``quant_int8``.

    ``quant_static`` adds the four ``act_scale_*`` parameters (ones until
    ``ops/calibration.py`` fills them). ``quant_calibrate`` runs the plain
    path (int8 forced off) and keeps the running per-channel maxima of the
    four quantisation points in the ``amax_*`` buffers. In train mode int8
    and calibration are off: a ``fused_block`` bf16 block runs the bf16
    kernels whatever the int8 flags say.

    The int8 kernels' operands (int8 weights, f32 scale vectors, folded
    LayerNorm parameters) are prepared once from the f32 parameters at the
    first forward and kept; :meth:`invalidate_prepared` drops them after the
    parameters change (``load_state_dict`` does so by itself).
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype,
                 fused_block: bool = False, device=None,
                 fast_gelu: bool = False, quant_int8: bool = False,
                 fused_attn: bool = False, quant_static: bool = False,
                 quant_calibrate: bool = False, param_dtype=None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.dtype = dtype
        self.fast_gelu = fast_gelu
        self.quant_int8 = quant_int8
        self.quant_static = quant_static
        self.quant_calibrate = quant_calibrate
        # the kernel path is bf16 only, as in the JAX package
        self.fused_train = fused_block and dtype == torch.bfloat16
        self.fused = self.fused_train and not quant_calibrate
        int8_dense = quant_int8 and not quant_calibrate and not self.fused
        # the int8 kernels quantise from f32 values, never from a bf16 copy
        pd = (torch.float32 if (quant_int8 and self.fused_train)
              else param_dtype)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = Attention(dim, num_heads, dtype, device=device,
                              quant_int8=int8_dense, fused_attn=fused_attn,
                              param_dtype=pd)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = MlpBlock(dim, hidden, dtype, device=device,
                            fast_gelu=fast_gelu, quant_int8=int8_dense,
                            param_dtype=pd)
        if quant_static:
            for point, ch in zip(QUANT_POINTS, (dim, dim, dim, hidden)):
                setattr(self, f"act_scale_{point}",
                        nn.Parameter(torch.ones(ch, device=device)))
        if quant_calibrate:
            for point, ch in zip(QUANT_POINTS, (dim, dim, dim, hidden)):
                self.register_buffer(f"amax_{point}",
                                     torch.zeros(ch, device=device),
                                     persistent=False)
        self._prepared: Optional[Dict[str, torch.Tensor]] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.invalidate_prepared())
        self.eval()

    def invalidate_prepared(self) -> None:
        self._prepared = None

    def _apply(self, fn, *args, **kwargs):
        self._prepared = None  # a move or a cast: prepare again there
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def prepared(self) -> Dict[str, torch.Tensor]:
        """The operand dict of this block's int8 kernel."""
        if self._prepared is None:
            flat = block_params(self)
            if self.quant_static:
                scales = {p: getattr(self, f"act_scale_{p}")
                          for p in QUANT_POINTS}
                self._prepared = quant.fold_static_scales(flat, scales)
            else:
                self._prepared = quant.prepare_int8(flat)
        return self._prepared

    def _tap(self, point: str) -> Callable:
        """Record the per-channel max-abs of an activation (running max)."""
        buf = getattr(self, f"amax_{point}")

        def tap(x):
            amax = torch.amax(torch.abs(x.detach().float()).reshape(
                -1, x.shape[-1]), dim=0)
            buf.copy_(torch.maximum(buf, amax))
        return tap

    def forward(self, x):
        train = self.training
        if self.fused_train if train else self.fused:
            if train or not self.quant_int8:
                return vit_block_fused_trainable(
                    x, block_params(self), self.num_heads,
                    self.fast_gelu).to(x.dtype)
            if self.quant_static:
                return vit_block_fused_int8_static(
                    x, self.prepared(), num_heads=self.num_heads,
                    fast_gelu=self.fast_gelu).to(x.dtype)
            return vit_block_fused_int8(
                x, self.prepared(), num_heads=self.num_heads,
                fast_gelu=self.fast_gelu).to(x.dtype)
        calib = self.quant_calibrate and not train
        y = self.norm1(x)
        if calib:
            self._tap("qkv")(y)
        x = x + self.attn(y, self._tap("proj") if calib else None).to(x.dtype)
        y = self.norm2(x)
        if calib:
            self._tap("mlp1")(y)
        return x + self.mlp(y, self._tap("mlp2") if calib else None).to(
            x.dtype)


class ViTBackbone(nn.Module):
    """Patchify -> +pos -> [+kpe tokens] -> blocks -> LN -> spatial map.

    Input: (B, H, W, in_ch) NHWC with (H, W) = ``img_hw``, (256, 192) for
    HaMeR. Output: (B, H/16, W/16, C) f32. ``kpe_emb`` (B, N, C) is added to
    the patch tokens when given.
    """

    def __init__(self, variant: str = "h", dtype=torch.float32,
                 fused_block: bool = False, device=None,
                 fast_gelu: bool = False, quant_int8: bool = False,
                 fused_attn: bool = False, quant_static: bool = False,
                 quant_calibrate: bool = False, param_dtype=None,
                 use_checkpoint: bool = False, img_hw=IMG_HW,
                 in_ch: int = 3):
        super().__init__()
        cfg = VIT_CONFIGS[variant]
        C = cfg["embed_dim"]
        self.dtype = dtype
        self.use_checkpoint = use_checkpoint
        pd = param_dtype or dtype
        self.embed_dim = C
        self.grid_hw = (img_hw[0] // PATCH, img_hw[1] // PATCH)
        # explicit 2-px zero padding (ViTPose's PatchEmbed); the bias is
        # added after the product is rounded, as flax nn.Conv does
        self.patch_embed = nn.Conv2d(in_ch, C, PATCH, stride=PATCH, padding=2,
                                     bias=False, dtype=pd, device=device)
        self.patch_bias = nn.Parameter(torch.zeros(C, dtype=pd,
                                                   device=device))
        n_tok = self.grid_hw[0] * self.grid_hw[1]
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_tok, C, dtype=pd, device=device))
        self.blocks = nn.ModuleList([
            Block(C, cfg["num_heads"], cfg["mlp_ratio"], dtype,
                  fused_block=fused_block, device=device,
                  fast_gelu=fast_gelu, quant_int8=quant_int8,
                  fused_attn=fused_attn, quant_static=quant_static,
                  quant_calibrate=quant_calibrate, param_dtype=param_dtype)
            for _ in range(cfg["depth"])
        ])
        self.last_norm = LayerNorm(C, device=device)
        self.eval()

    def forward(self, x, kpe_emb: Optional[torch.Tensor] = None):
        B = x.shape[0]
        hp, wp = self.grid_hw
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(self.dtype), None,
                     stride=PATCH, padding=2)
        y = y.permute(0, 2, 3, 1).reshape(B, hp * wp, self.embed_dim)
        y = y + self.patch_bias.to(self.dtype)
        y = y + self.pos_embed.to(self.dtype)
        if kpe_emb is not None:
            y = y + kpe_emb.to(self.dtype)
        for block in self.blocks:
            # a fused block keeps only its input already: no checkpoint on top
            if (self.use_checkpoint and self.training
                    and not block.fused_train):
                y = checkpoint(block, y, use_reentrant=False)
            else:
                y = block(y)
        y = self.last_norm(y)
        return y.reshape(B, hp, wp, self.embed_dim)


class VitB16Spatial(nn.Module):
    """ViT-B/16 + conv adapter -> a ResNet-50-shaped (B, side/32, side/32,
    2048) map: 2x2 average pool -> 3x3 conv to 2048 channels (``"SAME"``
    padding, bias) -> BatchNorm -> ReLU. NHWC in (``side`` x ``side`` x
    ``in_ch``, 224^2 gives 196 tokens) and out, in the compute dtype.

    Parameters are f32 masters, cast per call. In bf16 the blocks take the
    kernel route (``fused_block``: K3's kernels forward, K4's backward in
    training), which computes the JAX package's plain block; f32 runs the
    plain block."""

    def __init__(self, in_ch: int = 3, side: int = 224, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.vit = ViTBackbone("b16", dtype=dtype,
                               fused_block=dtype == torch.bfloat16,
                               device=device, param_dtype=torch.float32,
                               img_hw=(side, side), in_ch=in_ch)
        C = VIT_CONFIGS["b16"]["embed_dim"]
        self.adapter_conv = Conv(C, 2048, 3, 1, 1, dtype=dtype, use_bias=True,
                                 device=device)
        self.adapter_bn = BatchNorm(2048, dtype=dtype, device=device)

    def forward(self, x):
        y = F.avg_pool2d(self.vit(x).permute(0, 3, 1, 2), 2, 2)
        y = F.relu(self.adapter_bn(self.adapter_conv(y)))
        return y.permute(0, 2, 3, 1)
