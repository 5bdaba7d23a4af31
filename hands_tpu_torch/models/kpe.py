"""KPE: intrinsics-aware positional encodings (port of
``hands_tpu/models/kpe.py``).

Ray angles ``arctan2(p - c, f)`` encoded with frequencies ``2^0 .. 2^(L-1)``
as interleaved (sin, cos). Maps are NHWC, as in the JAX module. The angles
themselves come from ``hands_tpu_torch/ops/preprocess.py``.
"""

from __future__ import annotations

import torch


def sincos_pos_enc(angle: torch.Tensor, n_freq: int) -> torch.Tensor:
    """(B, C) angles -> (B, 2*n_freq*C) with layout [freq, chan, (sin, cos)]."""
    B = angle.shape[0]
    freqs = 2.0 ** torch.arange(n_freq, dtype=angle.dtype, device=angle.device)
    prod = freqs[None, :, None] * angle[:, None, :]  # (B, L, C)
    enc = torch.stack([torch.sin(prod), torch.cos(prod)], dim=-1)
    return enc.reshape(B, -1)


def center_pos_enc(angle: torch.Tensor, n_freq: int) -> torch.Tensor:
    """Center angles (B, 2) -> (B, 4*n_freq)."""
    return sincos_pos_enc(angle, n_freq)


def corner_pos_enc(angle: torch.Tensor, n_freq: int) -> torch.Tensor:
    """Corner angles (B, 8) -> (B, 16*n_freq)."""
    return sincos_pos_enc(angle, n_freq)


def resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of an NHWC map with ``align_corners=True`` semantics:
    sample positions ``in = out * (in_size - 1) / (out_size - 1)``, written
    out as the JAX module writes it (gather and lerp per axis)."""
    B, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x

    def axis_coords(n_in, n_out):
        if n_out == 1:
            z = torch.zeros(1, dtype=torch.long, device=x.device)
            return z, z, torch.zeros(1, dtype=x.dtype, device=x.device)
        s = torch.linspace(0.0, float(n_in - 1), n_out, device=x.device
                           ).to(x.dtype)
        i0 = torch.floor(s).long()
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return i0, i1, s - i0.to(x.dtype)

    y0, y1, wy = axis_coords(H, out_h)
    x0, x1, wx = axis_coords(W, out_w)
    v = (x[:, y0] * (1.0 - wy)[None, :, None, None]
         + x[:, y1] * wy[None, :, None, None])  # (B, out_h, W, C)
    return (v[:, :, x0] * (1.0 - wx)[None, None, :, None]
            + v[:, :, x1] * wx[None, None, :, None])


def dense_pos_enc(angle: torch.Tensor, mask: torch.Tensor, n_freq: int,
                  out_res: int) -> torch.Tensor:
    """Dense per-pixel angles (B, H, W, 2) + validity mask (B, H, W) ->
    (B, out_res, out_res, 4*n_freq), NHWC, channels [freq][chan][sin, cos]
    interleaved; the resize is ``align_corners=True`` bilinear."""
    B, H, W, C = angle.shape
    freqs = 2.0 ** torch.arange(n_freq, dtype=angle.dtype, device=angle.device)
    prod = angle[:, :, :, None, :] * freqs[None, None, None, :, None]
    enc = torch.stack([torch.sin(prod), torch.cos(prod)], dim=-1)
    enc = enc.reshape(B, H, W, n_freq * C * 2) * mask[..., None]
    return resize_align_corners(enc, out_res, out_res)


def broadcast_to_map(enc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, D) vector encoding -> (B, h, w, D) spatial broadcast (NHWC)."""
    return enc[:, None, None, :].expand(enc.shape[0], h, w, enc.shape[-1])
