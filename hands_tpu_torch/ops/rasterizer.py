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

:func:`soft_raster_silhouette` is the per-face soft rasteriser for
evaluation-quality masks: plain PyTorch, chunked over faces (the JAX function
is plain XLA too, and no model calls it).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from hands_tpu_torch.core.precision import f32_matmuls
from hands_tpu_torch.ops.cuda_build import CudaLibrary, check, on_cpu

_EPS = 1e-8
_CLIP = 1.0 - 1e-6

# kernel launches since the last reset (CPU twin runs are not counted)
launches: Dict[str, int] = {"splat_fwd": 0, "splat_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.splat_fwd.argtypes = [i, p, p, p, i, i, i, f, p]
    lib.splat_fwd.restype = ctypes.c_int
    lib.splat_bwd.argtypes = [i, p, p, p, p, i, i, i, f, p]
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
def splat_silhouette_plain(v2d: torch.Tensor, res: int,
                           sigma: float) -> torch.Tensor:
    """(B, V, 2) projected vertices in render pixels -> (B, res, res) soft
    mask. Stores the (B, P, V) pair tensors; the pairwise distance comes from
    one batched product, ``|p|^2 + |v|^2 - 2 p.v``."""
    B = v2d.shape[0]
    pix = _pixel_grid(res, v2d.dtype, v2d.device)  # (P, 2)
    p_sq = torch.sum(pix * pix, dim=-1)  # (P,)
    v_sq = torch.sum(v2d * v2d, dim=-1)  # (B, V)
    cross = torch.einsum("pc,bvc->bpv", pix, v2d)  # (B, P, V)
    d2 = p_sq[None, :, None] + v_sq[:, None, :] - 2.0 * cross
    g = torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * sigma * sigma))
    log_miss = torch.sum(torch.log1p(-torch.clamp(g, 0.0, _CLIP)), dim=-1)
    return (1.0 - torch.exp(log_miss)).reshape(B, res, res)


class _SplatFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v2d, res, sigma):
        B, V, _ = v2d.shape
        lm = torch.empty((B, res * res), dtype=torch.float32,
                         device=v2d.device)
        mask = torch.empty_like(lm)
        LIBRARY.launch("splat_fwd", v2d.device, v2d.data_ptr(), lm.data_ptr(),
                       mask.data_ptr(), B, V, res, sigma)
        launches["splat_fwd"] += 1
        ctx.save_for_backward(v2d, lm)
        ctx.res, ctx.sigma = res, sigma
        return mask.view(B, res, res)

    @staticmethod
    def backward(ctx, gmask):
        v2d, lm = ctx.saved_tensors
        B, V, _ = v2d.shape
        gmask = gmask.reshape(B, ctx.res * ctx.res).to(torch.float32)
        gmask = gmask.contiguous()
        dv = torch.empty_like(v2d)
        LIBRARY.launch("splat_bwd", v2d.device, v2d.data_ptr(), lm.data_ptr(),
                       gmask.data_ptr(), dv.data_ptr(), B, V, ctx.res,
                       ctx.sigma)
        launches["splat_bwd"] += 1
        return dv, None, None


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
