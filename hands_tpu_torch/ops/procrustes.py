"""Batched Procrustes / similarity alignment (port of
``hands_tpu/ops/procrustes.py``).

One batched ``torch.linalg.svd`` over the (B, 3, 3) correlation matrices.
Convention (3dpw-eval): R maximises trace(R'K), det(R) = +1 via a sign fix on
the last singular direction, scale = trace(RK) / var1. Float32, TF32 off.
The SVD runs where its input lies; on the card that is cuSOLVER.
"""

from __future__ import annotations

import torch

from hands_tpu_torch.core.precision import f32_matmuls


def _rotation_and_scale(K: torch.Tensor, var1: torch.Tensor):
    """(B, 3, 3) correlation and (B,) source variance -> R (B, 3, 3) with
    det +1 and the scale (B,)."""
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(1, 2)
    det = torch.linalg.det(U @ Vh)  # det(U V^T)
    z = torch.ones(K.shape[0], 3, dtype=K.dtype, device=K.device)
    z[:, 2] = torch.sign(det)
    R = (V * z[:, None, :]) @ U.transpose(1, 2)  # V diag(z) U^T
    scale = torch.einsum("bii->b", R @ K) / torch.clamp(var1, min=1e-12)
    return R, scale


@f32_matmuls
def similarity_align(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Align S1 to S2 with the optimal similarity transform (batched).

    S1, S2: (B, N, 3). Returns S1_hat = scale * R @ S1 + t, (B, N, 3).
    Degenerate inputs propagate NaNs."""
    X1 = S1.transpose(1, 2)  # (B, 3, N)
    X2 = S2.transpose(1, 2)
    mu1 = X1.mean(dim=2, keepdim=True)
    mu2 = X2.mean(dim=2, keepdim=True)
    X1c = X1 - mu1
    X2c = X2 - mu2
    var1 = torch.sum(X1c * X1c, dim=(1, 2))
    K = torch.einsum("bin,bjn->bij", X1c, X2c)
    R, scale = _rotation_and_scale(K, var1)
    t = mu2 - scale[:, None, None] * (R @ mu1)
    S1_hat = scale[:, None, None] * (R @ X1) + t
    return S1_hat.transpose(1, 2)


@f32_matmuls
def similarity_align_masked(S1: torch.Tensor, S2: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """Weighted similarity alignment using only the per-joint-valid entries:
    centroids, variance and correlation are weighted by ``valid`` (B, N); the
    transform is applied to all of S1 (errors of invalid joints are masked
    downstream)."""
    w = valid.to(S1.dtype)
    wn = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)  # (B, N)
    mu1 = torch.einsum("bn,bnc->bc", wn, S1)[:, None, :]
    mu2 = torch.einsum("bn,bnc->bc", wn, S2)[:, None, :]
    X1 = (S1 - mu1) * w[..., None]
    X2 = (S2 - mu2) * w[..., None]
    var1 = torch.sum(X1 * X1, dim=(1, 2))
    K = torch.einsum("bni,bnj->bij", X1, X2)
    R, scale = _rotation_and_scale(K, var1)
    t = mu2.transpose(1, 2) - scale[:, None, None] * (R @ mu1.transpose(1, 2))
    S1_hat = scale[:, None, None] * (R @ S1.transpose(1, 2)) + t
    return S1_hat.transpose(1, 2)
