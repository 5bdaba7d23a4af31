"""Differentiable silhouette rendering for the mask loss (port of
``hands_tpu/ops/rasterizer.py``: ``splat_silhouette``,
``soft_raster_silhouette`` and ``render_silhouette``; and of
``hands_tpu/ops/rasterizer_pallas.py``: ``splat_silhouette_fused``).

Gaussian vertex splatting: ``mask(p) = 1 - prod_v (1 - exp(-|p - proj(v)|^2
/ 2 sigma^2))``, computed in log space. The MANO mesh is dense (778 vertices
on a hand crop), so a ~3 px sigma at 224^2 gives a near-solid silhouette with
smooth gradients to every vertex.

:func:`splat_silhouette_fused` takes projected vertices. CUDA tensors launch
the two kernels of ``csrc/splat.cu`` (forward, and backward through a
``torch.autograd.Function``; one launch each, counted in :data:`launches`);
CPU tensors run :func:`splat_silhouette_plain`, which autograd
differentiates; anything else raises. Projection, the render scale and the
bilinear resize to the image resolution stay in PyTorch around it.

Where a gaussian is clipped (a vertex within 1e-3 px of a pixel centre) the
plain version's ``clamp`` passes no gradient while the kernel's formula does;
vertices from a network do not land there, and the tests' seeded ones do not.

**Which pairs the kernels skip.** In f32, ``exp(x)`` is exactly 0 for every
``x <= EXP_ZERO`` (-103.972084, the largest f32 below -150 ln 2, where the
true value falls under half the least subnormal). :func:`cut_d2` turns that
into a squared distance: the least f32 ``d2`` with
``f32(-d2 / f32(2 sigma^2)) <= EXP_ZERO``, 468 px^2 (21.6 px) at sigma 1.5.
A pair whose computed ``d2`` reaches it adds ``log1p(-0) = -0`` to the
forward's sum, which leaves every f32 value as it was, and ``A 0 / (1 - 0)
(v - p) = 0`` to the backward's. The kernels skip pixel-vertex pairs in
regions (a tile of pixels, the rectangle around a vertex), so they decide on
the exact distance, not on the computed one, which cancels in ``(|p|^2 +
|v|^2) - 2 p.v`` by up to ~5 f32 roundings of ``|p|^2 + |v|^2``: a pair is
skipped only where the distance, formed in f64, reaches
:func:`skip_threshold`, ``cut_d2`` plus a margin of 2^-20 of ``cut_d2 + 2
res^2 + |v|^2`` (three times that rounding, and the backward's multiplication
by ``1 / 2 sigma^2`` in place of the forward's division). So the forward
returns, bit for bit, what the dense loop returns, and the backward sums the
same nonzero terms in another order. Vertices with a coordinate beyond
:data:`FAR` px, infinite or NaN are never skipped: their f32 products can
overflow, and the kernels give them the dense loop's arithmetic.
``cut_d2`` is computed here from sigma and handed to both launches; nothing
else sets it and nothing turns the skipping off.

:func:`soft_raster_silhouette` is the per-face soft rasteriser for
evaluation-quality masks: plain PyTorch, chunked over faces (the JAX function
is plain XLA too, and no model calls it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.ops.cuda_build import CudaLibrary, check, on_cpu

_EPS = 1e-8
_CLIP = 1.0 - 1e-6
# the largest f32 whose exp rounds to 0 (csrc/splat.cu: kExpZero)
EXP_ZERO = float.fromhex("-0x1.9fe36ap+6")
# vertices with a coordinate beyond this (or not finite) are never skipped
FAR = 1e18
# the margin of skip_threshold, relative to cut_d2 + 2 res^2 + |v|^2
MARGIN = 2.0**-20


def two_sigma_sq(sigma: float) -> np.float32:
    """``2 sigma^2`` as the kernels' launch computes it in f32."""
    s = np.float32(sigma)
    return np.float32(2.0) * s * s


@functools.lru_cache(maxsize=None)
def cut_d2(sigma: float) -> float:
    """The least f32 squared distance whose gaussian the forward kernel
    computes as exactly 0: ``f32(-d2 / f32(2 sigma^2)) <= EXP_ZERO`` for this
    ``d2`` and every larger one (division and exp are monotone)."""
    t, x0 = two_sigma_sq(sigma), np.float32(EXP_ZERO)
    up, down = np.float32(np.inf), np.float32(0.0)

    def zero(d):
        return np.float32(-d) / t <= x0

    d = np.float32(-float(x0) * float(t))
    while not zero(d):
        d = np.nextafter(d, up)
    while zero(np.nextafter(d, down)):
        d = np.nextafter(d, down)
    return float(d)


def skip_threshold(v_sq, cut: float, res: int):
    """The exact squared distance (formed in f64) from which the kernels
    skip a pair: ``cut`` plus :data:`MARGIN` of ``cut + 2 res^2 + |v|^2``,
    with ``v_sq`` the vertex's ``|v|^2`` in f64 (a float or an array). Its
    pairs' computed distance is then at least ``cut``, also after the
    cancellation of ``(|p|^2 + |v|^2) - 2 p.v`` in f32."""
    return cut + MARGIN * (cut + 2.0 * res * res + v_sq)

# kernel launches since the last reset (CPU twin runs are not counted)
launches: Dict[str, int] = {"splat_fwd": 0, "splat_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.splat_fwd.argtypes = [i, p, p, p, i, i, i, f, f, p]
    lib.splat_fwd.restype = ctypes.c_int
    lib.splat_bwd.argtypes = [i, p, p, p, p, i, i, i, f, f, p]
    lib.splat_bwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("splat", _bind, "splat_error_string")


@f32_matmuls
def _project(verts_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    proj = torch.einsum("bij,bvj->bvi", K, verts_cam)
    return proj[..., :2] / torch.clamp(proj[..., 2:3], min=_EPS)


def _pixel_grid(res: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(P, 2) pixel centres [x, y], row-major over the image."""
    c = torch.arange(res, dtype=dtype, device=device) + 0.5
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(-1, 2)


@f32_matmuls
def splat_gaussians(v2d: torch.Tensor, res: int,
                    sigma: float) -> torch.Tensor:
    """(B, V, 2) projected vertices -> (B, P, V) gaussians of every
    pixel-vertex pair; the pairwise distance comes from one batched product,
    ``|p|^2 + |v|^2 - 2 p.v``."""
    pix = _pixel_grid(res, v2d.dtype, v2d.device)  # (P, 2)
    p_sq = torch.sum(pix * pix, dim=-1)  # (P,)
    v_sq = torch.sum(v2d * v2d, dim=-1)  # (B, V)
    cross = torch.einsum("pc,bvc->bpv", pix, v2d)  # (B, P, V)
    d2 = p_sq[None, :, None] + v_sq[:, None, :] - 2.0 * cross
    return torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * sigma * sigma))


def silhouette_from_gaussians(g: torch.Tensor, res: int) -> torch.Tensor:
    """(B, P, V) gaussians -> (B, res, res) soft mask, in log space."""
    log_miss = torch.sum(torch.log1p(-torch.clamp(g, 0.0, _CLIP)), dim=-1)
    return (1.0 - torch.exp(log_miss)).reshape(g.shape[0], res, res)


def splat_silhouette_plain(v2d: torch.Tensor, res: int,
                           sigma: float) -> torch.Tensor:
    """(B, V, 2) projected vertices in render pixels -> (B, res, res) soft
    mask. Stores the (B, P, V) pair tensors and evaluates every pair."""
    return silhouette_from_gaussians(splat_gaussians(v2d, res, sigma), res)


def _launch_fwd(v2d: torch.Tensor, res: int, sigma: float):
    """The forward kernel on (B, V, 2) CUDA vertices: (lm, mask), each
    (B, res * res) f32."""
    B, V, _ = v2d.shape
    lm = torch.empty((B, res * res), dtype=torch.float32, device=v2d.device)
    mask = torch.empty_like(lm)
    LIBRARY.launch("splat_fwd", v2d.device, v2d.data_ptr(), lm.data_ptr(),
                   mask.data_ptr(), B, V, res, sigma, cut_d2(sigma))
    launches["splat_fwd"] += 1
    return lm, mask


def _launch_bwd(v2d: torch.Tensor, lm: torch.Tensor, gmask: torch.Tensor,
                res: int, sigma: float) -> torch.Tensor:
    """The backward kernel: (B, V, 2) vertices, the forward's (B, res * res)
    log-miss map and the mask's gradient -> the vertices' gradient."""
    B, V, _ = v2d.shape
    dv = torch.empty_like(v2d)
    LIBRARY.launch("splat_bwd", v2d.device, v2d.data_ptr(), lm.data_ptr(),
                   gmask.data_ptr(), dv.data_ptr(), B, V, res, sigma,
                   cut_d2(sigma))
    launches["splat_bwd"] += 1
    return dv


class _SplatFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v2d, res, sigma):
        B = v2d.shape[0]
        lm, mask = _launch_fwd(v2d, res, sigma)
        ctx.save_for_backward(v2d, lm)
        ctx.res, ctx.sigma = res, sigma
        return mask.view(B, res, res)

    @staticmethod
    def backward(ctx, gmask):
        v2d, lm = ctx.saved_tensors
        gmask = gmask.reshape(lm.shape).to(torch.float32).contiguous()
        return _launch_bwd(v2d, lm, gmask, ctx.res, ctx.sigma), None, None


def splat_silhouette_fused(v2d: torch.Tensor, res: int,
                           sigma: float) -> torch.Tensor:
    """Gaussian vertex-splat silhouette of (B, V, 2) projected vertices (in
    pixels of the ``res`` x ``res`` render) -> (B, res, res), f32."""
    if on_cpu(v2d):
        return splat_silhouette_plain(v2d, res, sigma)
    B, V, _ = v2d.shape
    if B == 0:
        return v2d.new_zeros((0, res, res))
    check(v2d, "v2d", torch.float32, (B, V, 2), v2d.device)
    return _SplatFused.apply(v2d, int(res), float(sigma))


def splat_silhouette(verts_cam: torch.Tensor, K: torch.Tensor, img_res: int,
                     sigma_px: float = 3.0,
                     render_res: Optional[int] = None) -> torch.Tensor:
    """Camera-space vertices (B, V, 3) and intrinsics (B, 3, 3) ->
    (B, img_res, img_res) silhouette in [0, 1], rendered at ``render_res``
    and resized bilinearly (half-pixel centres) to ``img_res``."""
    render_res = render_res or img_res
    scale = render_res / img_res
    v2d = (_project(verts_cam, K) * scale).contiguous()
    mask = splat_silhouette_fused(v2d, render_res, sigma_px * scale)
    if render_res != img_res:
        mask = F.interpolate(mask[:, None], size=(img_res, img_res),
                             mode="bilinear", align_corners=False,
                             antialias=False)[:, 0]
    return mask


@f32_matmuls
def soft_raster_silhouette(verts_cam: torch.Tensor, faces: torch.Tensor,
                           K: torch.Tensor, img_res: int,
                           sigma_px: float = 1.0,
                           render_res: Optional[int] = None,
                           face_chunk: int = 128) -> torch.Tensor:
    """Per-face soft rasterised silhouette: (B, V, 3) vertices, (F, 3) int
    faces, (B, 3, 3) intrinsics -> (B, img_res, img_res).

    For each face a signed distance proxy d = min over the three edge
    functions (positive inside, either winding); per-face coverage =
    sigmoid(d / sigma); silhouette = 1 - prod_f (1 - cov_f), accumulated in
    log space over chunks of ``face_chunk`` faces so that the peak tensor is
    (B, face_chunk, P)."""
    render_res = render_res or img_res
    scale = render_res / img_res
    B = verts_cam.shape[0]
    v2d = _project(verts_cam, K) * scale  # (B, V, 2)
    pix = _pixel_grid(render_res, verts_cam.dtype, verts_cam.device)
    sig = sigma_px * scale

    def edge_dist(a, b):
        # signed distance of the pixels to the edge a->b, positive on the
        # left. The norm is clamped so a degenerate face keeps a finite
        # gradient.
        e = b - a  # (B, C, 2)
        n = torch.stack([-e[..., 1], e[..., 0]], dim=-1)  # left normal
        norm = torch.sqrt(torch.clamp(
            torch.sum(n * n, dim=-1, keepdim=True), min=_EPS * _EPS))
        n = n / norm
        return (torch.einsum("pc,bfc->bfp", pix, n)
                - torch.sum(a * n, dim=-1)[..., None])

    log_miss = torch.zeros((B, pix.shape[0]), dtype=verts_cam.dtype,
                           device=verts_cam.device)
    faces = faces.long()
    for start in range(0, faces.shape[0], face_chunk):
        f = faces[start:start + face_chunk]  # (C, 3)
        va, vb, vc = v2d[:, f[:, 0]], v2d[:, f[:, 1]], v2d[:, f[:, 2]]
        d0, d1, d2 = edge_dist(va, vb), edge_dist(vb, vc), edge_dist(vc, va)
        d_ccw = torch.minimum(torch.minimum(d0, d1), d2)
        d_cw = torch.minimum(torch.minimum(-d0, -d1), -d2)
        cov = torch.sigmoid(torch.maximum(d_ccw, d_cw) / sig)  # (B, C, P)
        log_miss = log_miss + torch.sum(
            torch.log1p(-torch.clamp(cov, 0.0, _CLIP)), dim=1)
    mask = (1.0 - torch.exp(log_miss)).reshape(B, render_res, render_res)
    if render_res != img_res:
        mask = F.interpolate(mask[:, None], size=(img_res, img_res),
                             mode="bilinear", align_corners=False,
                             antialias=False)[:, 0]
    return mask


def render_silhouette(verts_cam: torch.Tensor, faces: torch.Tensor,
                      K: torch.Tensor, img_res: int) -> torch.Tensor:
    """The mask-loss silhouette: vertex splatting at half resolution
    (``faces`` is unused, as in the JAX function)."""
    return splat_silhouette(verts_cam, K, img_res, sigma_px=3.0,
                            render_res=img_res // 2)
