"""HaMeR MANO head (port of ``hands_tpu/models/heads/hamer_head.py``).

One learned query token cross-attends to the ViT token map through a 6-layer
transformer decoder (dim 1024, 8 heads of 64), then additive readouts for
pose (16 x 6D), shape (10) and weak-perspective camera (3) on top of the
mean-parameter initialisation. Plain PyTorch in f32.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
from torch import nn

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.models.backbones.vit import Dense, LayerNorm
from hands_tpu_torch.ops.vit_block import gelu_erfc


def load_mean_params() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pose (96, 6D), betas (10), cam (3)) from ``mano_mean_params.npz``
    under ``DATA_DIR`` if present, else identity pose, zero betas and
    cam [0.9, 0, 0]."""
    path = os.path.join(
        os.environ.get("DATA_DIR", ""), "hamer/_DATA/data/mano_mean_params.npz")
    if os.environ.get("DATA_DIR") and os.path.exists(path):
        d = np.load(path)
        return (
            d["pose"].astype(np.float32).reshape(-1),
            d["shape"].astype(np.float32).reshape(-1),
            d["cam"].astype(np.float32).reshape(-1),
        )
    ident6d = np.tile(np.asarray([1, 0, 0, 0, 1, 0], np.float32), 16)
    return (ident6d, np.zeros(10, np.float32),
            np.asarray([0.9, 0, 0], np.float32))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int = 8,
                 dim_head: int = 64, device=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.to_q = Dense(dim, inner, use_bias=False, device=device)
        self.to_kv = Dense(context_dim, 2 * inner, use_bias=False,
                           device=device)
        self.to_out = Dense(inner, dim, device=device)

    def forward(self, x, context):
        B, N, _ = x.shape
        q = self.to_q(x)
        k, v = torch.chunk(self.to_kv(context), 2, dim=-1)

        def heads_first(t):  # (B, L, H*Dh) -> (B, H, L, Dh)
            return t.reshape(B, -1, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads_first(q), heads_first(k), heads_first(v)
        attn = torch.matmul(q * self.dim_head**-0.5, k.transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, -1)
        return self.to_out(out)


class DecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention and MLP; LayerNorm eps 1e-5
    (the torch defaults of the HaMeR decoder)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 mlp_dim: int, device=None):
        super().__init__()
        self.norm0 = LayerNorm(dim, eps=1e-5, device=device)
        self.self_attn = CrossAttention(dim, dim, heads, dim_head, device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.cross_attn = CrossAttention(dim, context_dim, heads, dim_head,
                                         device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.fc1 = Dense(dim, mlp_dim, device=device)
        self.fc2 = Dense(mlp_dim, dim, device=device)

    def forward(self, x, context):
        y = self.norm0(x)
        x = x + self.self_attn(y, y)
        x = x + self.cross_attn(self.norm1(x), context)
        return x + self.fc2(gelu_erfc(self.fc1(self.norm2(x))))


class ManoTransformerDecoderHead(nn.Module):
    """ViT token map (B, h, w, C_ctx) -> MANO params: pose (B, 16, 3, 3)
    rotation matrices, betas (B, 10), weak-perspective cam (B, 3)."""

    def __init__(self, context_dim: int, dim: int = 1024, depth: int = 6,
                 heads: int = 8, dim_head: int = 64, mlp_dim: int = 1024,
                 ief_iters: int = 1, device=None):
        super().__init__()
        self.ief_iters = ief_iters
        self.token_proj = Dense(1, dim, device=device)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.layers = nn.ModuleList([
            DecoderLayer(dim, context_dim, heads, dim_head, mlp_dim, device)
            for _ in range(depth)
        ])
        self.decpose = Dense(dim, 96, device=device)
        self.decshape = Dense(dim, 10, device=device)
        self.deccam = Dense(dim, 3, device=device)
        pose, betas, cam = load_mean_params()
        self.register_buffer("mean_pose", torch.from_numpy(pose).to(device))
        self.register_buffer("mean_betas", torch.from_numpy(betas).to(device))
        self.register_buffer("mean_cam", torch.from_numpy(cam).to(device))

    def forward(self, feat_map: torch.Tensor) -> dict:
        B = feat_map.shape[0]
        context = feat_map.reshape(B, -1, feat_map.shape[-1])
        pred_pose = self.mean_pose[None].expand(B, -1)
        pred_betas = self.mean_betas[None].expand(B, -1)
        pred_cam = self.mean_cam[None].expand(B, -1)
        for _ in range(self.ief_iters):
            # a zero input token: token_proj's bias plus the learned query
            token = self.token_proj(
                torch.zeros((B, 1, 1), device=feat_map.device))
            token = token + self.pos_embedding
            for layer in self.layers:
                token = layer(token, context)
            token = token[:, 0]
            pred_pose = self.decpose(token) + pred_pose
            pred_betas = self.decshape(token) + pred_betas
            pred_cam = self.deccam(token) + pred_cam
        rotmats = rotlib.rot6d_to_matrix_hamer(pred_pose.reshape(B, 16, 6))
        return {"pose": rotmats, "shape": pred_betas, "cam_t.wp": pred_cam}
