"""Iterative HMR regression heads (port of ``hands_tpu/models/heads/hmr.py``).

Parameter spec: ``pose_6d`` (96), ``cam_t_wp`` (3), ``shape`` (10). The
``n_iter`` refinement loop is unrolled; each decoder is a small linear layer
(Flax initialises it xavier-uniform with gain 0.01, so early iterations stay
near the identity-pose start). Plain PyTorch in f32. In train mode
(``module.train()``) ``HMRLayer`` drops half of each refinement activation, as
the Flax module does; the masks come from the ``torch.Generator`` the caller
passes, so a seed fixes them. ``TfHMRLayer`` has no dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hands_tpu_torch.core import rot as rotlib
from hands_tpu_torch.models.backbones.vit import Dense

HAND_SPECS: Dict[str, int] = {"pose_6d": 6 * 16, "cam_t_wp": 3, "shape": 10}
_N_PARAMS = sum(HAND_SPECS.values())  # 109


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each entry with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; the mask is drawn from ``generator``
    on ``x``'s device."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _decoders(mid_dim: int, specs, device) -> nn.ModuleDict:
    return nn.ModuleDict({key: Dense(mid_dim, size, device=device)
                          for key, size in specs})


class HMRLayer(nn.Module):
    """Additive iterative refinement: concat(feat, params) -> MLP -> deltas."""

    dropout_rate = 0.5  # of each refinement activation, in train mode

    def __init__(self, feat_dim: int, mid_dim: int = 1024,
                 specs: Tuple[Tuple[str, int], ...] = tuple(HAND_SPECS.items()),
                 n_iter: int = 3, device=None):
        super().__init__()
        self.specs, self.n_iter = specs, n_iter
        vec_dim = sum(size for _, size in specs)
        self.refine0 = Dense(feat_dim + vec_dim, mid_dim, device=device)
        self.refine1 = Dense(mid_dim, mid_dim, device=device)
        self.dec = _decoders(mid_dim, specs, device)
        self.eval()  # as the Flax module's train=False default

    def forward(self, feat: torch.Tensor, init_vec: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        def drop(x):
            if not self.training:
                return x
            return dropout(x, self.dropout_rate, generator)

        pred = dict(init_vec)
        for _ in range(self.n_iter):
            # concatenated in the init dict's insertion order (pose_6d,
            # shape, cam_t_wp), NOT the specs' order
            vec = torch.cat(list(pred.values()), dim=-1)
            xc = torch.cat([feat, vec], dim=-1)
            xc = drop(F.relu(self.refine0(xc)))
            xc = drop(F.relu(self.refine1(xc)))
            for key, _ in self.specs:
                pred[key] = pred[key] + self.dec[key](xc)
        return pred


class TorchMHA(nn.Module):
    """``nn.MultiheadAttention``-compatible attention: fused in-projection
    stored (3d, d) as ``in_proj_weight``, output projection, scale =
    head_dim^-0.5."""

    def __init__(self, dim: int, num_heads: int = 1, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = Dense(dim, dim, device=device)

    def forward(self, q, k, v):
        d, H = self.dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        qp = F.linear(q, w[:d]) + b[:d]
        kp = F.linear(k, w[d:2 * d]) + b[d:2 * d]
        vp = F.linear(v, w[2 * d:]) + b[2 * d:]
        B, N, _ = qp.shape
        hd = d // H

        def heads(z):  # (B, L, d) -> (B, H, L, hd)
            return z.reshape(B, -1, H, hd).transpose(1, 2)

        attn = torch.matmul(heads(qp) * hd**-0.5,
                            heads(kp).transpose(-1, -2))  # (B, H, N, M)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.matmul(attn, heads(vp)).transpose(1, 2).reshape(B, N, d)
        return self.out_proj(out)


class TfHMRLayer(nn.Module):
    """Transformer-decoder refinement: each scalar of the 109-dim parameter
    vector becomes a token (Linear 1->mid, ReLU), the spatial features become
    memory tokens (Linear feat->mid, ReLU), then one norm-free decoder layer
    (self-attention, cross-attention, ReLU feed-forward) and one norm-free
    encoder layer (self-attention, ReLU feed-forward), the mean over tokens,
    additive decoders."""

    def __init__(self, feat_dim: int, mid_dim: int = 1024,
                 specs: Tuple[Tuple[str, int], ...] = tuple(HAND_SPECS.items()),
                 n_iter: int = 3, device=None):
        super().__init__()
        self.specs, self.n_iter = specs, n_iter
        kw = dict(device=device)
        self.feat_mlp_dense = Dense(feat_dim, mid_dim, **kw)
        self.vector_mlp_dense = Dense(1, mid_dim, **kw)
        self.dec_self_attn = TorchMHA(mid_dim, **kw)
        self.dec_cross_attn = TorchMHA(mid_dim, **kw)
        self.dec_linear1 = Dense(mid_dim, mid_dim, **kw)
        self.dec_linear2 = Dense(mid_dim, mid_dim, **kw)
        self.enc_self_attn = TorchMHA(mid_dim, **kw)
        self.enc_linear1 = Dense(mid_dim, mid_dim, **kw)
        self.enc_linear2 = Dense(mid_dim, mid_dim, **kw)
        self.dec = _decoders(mid_dim, specs, device)

    def forward(self, feat_map: torch.Tensor,
                init_vec: Dict[str, torch.Tensor], generator=None):
        B = feat_map.shape[0]
        mem = feat_map.reshape(B, -1, feat_map.shape[-1])  # NHWC: row-major
        memory = F.relu(self.feat_mlp_dense(mem))  # (B, S, mid)
        pred = dict(init_vec)
        for _ in range(self.n_iter):
            vec = torch.cat(list(pred.values()), dim=-1)
            tgt = F.relu(self.vector_mlp_dense(vec[..., None]))  # (B,109,mid)
            x = tgt + self.dec_self_attn(tgt, tgt, tgt)
            x = x + self.dec_cross_attn(x, memory, memory)
            x = x + self.dec_linear2(F.relu(self.dec_linear1(x)))
            x = x + self.enc_self_attn(x, x, x)
            x = x + self.enc_linear2(F.relu(self.enc_linear1(x)))
            xc = x.mean(dim=1)
            for key, _ in self.specs:
                pred[key] = pred[key] + self.dec[key](xc)
        return pred


class HandHMR(nn.Module):
    """Per-hand HMR head: weak-perspective camera init MLP + refinement.

    Takes a feature vector (B, feat_dim), or with ``tf_decoder`` a spatial
    map (B, h, w, C) NHWC. Returns ``pose`` (B, 16, 3, 3) rotation matrices,
    ``shape`` (B, 10), ``cam_t.wp`` (B, 3) and ``cam_t.wp.init`` (B, 3).
    """

    def __init__(self, feat_dim: int, in_dim: int | None = None,
                 n_iter: int = 3, tf_decoder: bool = False, device=None):
        super().__init__()
        in_dim = feat_dim if in_dim is None else in_dim
        self.tf_decoder = tf_decoder
        kw = dict(device=device)
        cam_in = feat_dim if tf_decoder else in_dim
        self.cam_init = nn.ModuleList([Dense(cam_in, 512, **kw),
                                       Dense(512, 512, **kw),
                                       Dense(512, 3, **kw)])
        if tf_decoder:
            self.cam_init_pre = Dense(in_dim, feat_dim, **kw)
            self.tf_hmr_layer = TfHMRLayer(in_dim, n_iter=n_iter, **kw)
        else:
            self.hmr_layer = HMRLayer(in_dim, n_iter=n_iter, **kw)

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        B = feat.shape[0]
        x = feat
        if self.tf_decoder:
            x = F.relu(self.cam_init_pre(feat)).mean(dim=(1, 2))
        init_transl = self.cam_init[2](F.relu(self.cam_init[1](
            F.relu(self.cam_init[0](x)))))

        # pytorch3d row-major 6D (the HaMeR head uses the column layout)
        ident6d = rotlib.matrix_to_rot6d(
            torch.eye(3, dtype=torch.float32, device=feat.device)[None])
        init_vec = {
            "pose_6d": ident6d.reshape(1, 6).repeat(B, 16),
            "shape": torch.zeros((B, 10), device=feat.device),
            "cam_t_wp": init_transl,
        }
        layer = self.tf_hmr_layer if self.tf_decoder else self.hmr_layer
        pred = layer(feat, init_vec, generator)
        rotmat = rotlib.rot6d_to_matrix(pred["pose_6d"].reshape(B, 16, 6))
        return {
            "pose": rotmat,
            "shape": pred["shape"],
            "cam_t.wp": pred["cam_t_wp"],
            "cam_t.wp.init": init_transl,
        }
