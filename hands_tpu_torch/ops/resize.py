"""Image resizes with the semantics of ``jax.image.resize`` (the JAX
package's resize of feature maps, images and position grids).

``jax.image.resize`` samples at half-pixel centres, ``in = (out + 0.5) *
in_size / out_size - 0.5``, and builds one weight matrix per resized axis:

- ``"bilinear"``: the triangle kernel; ``"bicubic"``: Keys' cubic with
  a = -0.5 (``F.interpolate(mode="bicubic")`` uses a = -0.75, another
  function);
- when an axis shrinks, the kernel is widened by ``in_size / out_size``
  (antialiasing), so every input pixel under the footprint contributes;
- each output's weights are divided by their sum, which clamps the samples
  at the borders.

The weight matrices are made in f32 as JAX makes them, cast to the input's
dtype, and applied as products over H and W. An upsampling bilinear resize
is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` to f32 rounding; this module is what the shrinks, the
bicubic grid and the mixed cases need. Maps are NHWC.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hands_tpu_torch.core.precision import f32_exact

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str) -> torch.Tensor:
    """(n_in, n_out) f32 weights of one axis, as ``jax.image.resize``'s
    ``compute_weight_mat`` makes them with its default antialiasing (CPU
    tensor; cached)."""
    kernel = _KERNELS[method]
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    k_scale = torch.clamp(inv, min=1.0)  # widened only where it shrinks
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
    w = kernel(x / k_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, h: int, w: int,
           method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), method)`` of an NHWC map; axes of
    unchanged size are left alone, as JAX leaves them."""
    out = x
    with f32_exact():  # the f32 products stay f32 on the card (no TF32)
        if x.shape[1] != h:
            m = weight_matrix(x.shape[1], h, method)
            out = torch.einsum("bhwc,hk->bkwc", out,
                               m.to(device=x.device, dtype=x.dtype))
        if x.shape[2] != w:
            m = weight_matrix(x.shape[2], w, method)
            out = torch.einsum("bhwc,wk->bhkc", out,
                               m.to(device=x.device, dtype=x.dtype))
    return out
