"""ViT backbone for HaMeR (port of ``hands_tpu/models/backbones/vit.py``).

ViTPose-style, no class token: patchify -> + pos -> [+ KPE tokens] -> blocks
-> LayerNorm -> (B, H/16, W/16, C) NHWC feature map. The JAX package's
scan-stacked blocks become an ``nn.ModuleList``.

Dtypes follow the Flax modules: in a bf16 backbone the matmul weights and
biases are stored in bf16 (the values Flax's per-call cast produces),
LayerNorms compute and return f32, and every dense product is rounded to the
compute dtype before its bias is added (Flax ``nn.Dense``'s rounding point).
With ``fused_block`` and bf16 a block runs the hand-written kernels of
``ops/vit_block.py``; otherwise the plain modules below.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hands_tpu_torch.ops.vit_block import (block_params, gelu_erfc,
                                           layernorm_f32, vit_block_fused)

PATCH = 16
IMG_HW = (256, 192)  # HaMeR's ViT input: 16 x 12 patches
VIT_CONFIGS = {
    "h": dict(embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4.0),
    # a small variant for tests
    "tiny": dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=2.0),
}


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
    ``+ b`` in ``dtype``. The weight is stored (out, in), as ``nn.Linear``."""

    def __init__(self, in_f: int, out_f: int, dtype=torch.float32,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_f, in_f, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_f, dtype=dtype, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight)
        return y if self.bias is None else y + self.bias


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype, device=device)

    def forward(self, x):
        return self.fc2(gelu_erfc(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype, device=device)
        self.proj = Dense(dim, dim, dtype, device=device)

    def forward(self, x):
        # x: the f32 LayerNorm output. As in the Flax module, logits come
        # out of the product in the compute dtype, the softmax runs in f32
        # and the probabilities keep x's dtype, so p.v promotes v to f32.
        B, N, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).view(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, D)
        scale = torch.tensor(D**-0.5, dtype=q.dtype, device=q.device)
        attn = torch.matmul(q * scale, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v.to(attn.dtype))
        return self.proj(out.permute(0, 2, 1, 3).reshape(B, N, C))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype,
                 fused_block: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        # the kernel path is bf16 only, as in the JAX package
        self.fused = fused_block and dtype == torch.bfloat16
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = Attention(dim, num_heads, dtype, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype, device=device)

    def forward(self, x):
        if self.fused:
            return vit_block_fused(x, block_params(self),
                                   num_heads=self.num_heads)
        x = x + self.attn(self.norm1(x)).to(x.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


class ViTBackbone(nn.Module):
    """Patchify -> +pos -> [+kpe tokens] -> blocks -> LN -> spatial map.

    Input: (B, 256, 192, 3) NHWC. Output: (B, 16, 12, C) f32. ``kpe_emb``
    (B, N, C) is added to the patch tokens when given.
    """

    def __init__(self, variant: str = "h", dtype=torch.float32,
                 fused_block: bool = False, device=None):
        super().__init__()
        cfg = VIT_CONFIGS[variant]
        C = cfg["embed_dim"]
        self.dtype = dtype
        self.embed_dim = C
        self.grid_hw = (IMG_HW[0] // PATCH, IMG_HW[1] // PATCH)
        # explicit 2-px zero padding (ViTPose's PatchEmbed); the bias is
        # added after the product is rounded, as flax nn.Conv does
        self.patch_embed = nn.Conv2d(3, C, PATCH, stride=PATCH, padding=2,
                                     bias=False, dtype=dtype, device=device)
        self.patch_bias = nn.Parameter(torch.zeros(C, dtype=dtype,
                                                   device=device))
        n_tok = self.grid_hw[0] * self.grid_hw[1]
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_tok, C, dtype=dtype, device=device))
        self.blocks = nn.ModuleList([
            Block(C, cfg["num_heads"], cfg["mlp_ratio"], dtype,
                  fused_block=fused_block, device=device)
            for _ in range(cfg["depth"])
        ])
        self.last_norm = LayerNorm(C, device=device)

    def forward(self, x, kpe_emb: Optional[torch.Tensor] = None):
        B = x.shape[0]
        hp, wp = self.grid_hw
        y = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        y = y.permute(0, 2, 3, 1).reshape(B, hp * wp, self.embed_dim)
        y = y + self.patch_bias
        y = y + self.pos_embed
        if kpe_emb is not None:
            y = y + kpe_emb.to(self.dtype)
        for block in self.blocks:
            y = block(y)
        y = self.last_norm(y)
        return y.reshape(B, hp, wp, self.embed_dim)
