"""KPE: intrinsics-aware positional encodings (port of
``hands_tpu/models/kpe.py``, the center/corner encoders).

Ray angles ``arctan2(p - c, f)`` encoded with frequencies ``2^0 .. 2^(L-1)``
as interleaved (sin, cos).
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
