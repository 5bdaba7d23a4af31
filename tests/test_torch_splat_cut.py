"""The pairs that the splat kernels (K2, ``hands_tpu_torch/csrc/splat.cu``)
skip: ``rasterizer.cut_d2`` and ``rasterizer.skip_threshold`` against f32
arithmetic evaluated the kernels' way on the CPU (f32 division or product,
then exp; the distance ``(|p|^2 + |v|^2) - 2 fma(p_y, v_y, p_x v_x)``), and
the dense plain twin with the skipped pairs' gaussians set to 0 against the
twin itself, bit for bit. Inputs from a numpy seed; no tolerance: every
check is exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hands_tpu_torch.ops import rasterizer as ras
from hands_tpu_torch.ops.quant import fma_f32

SIGMAS = (0.5, 1.5, 3.0, 12.0, 40.0)
f32 = np.float32


def _g_fwd(d2, sigma):
    """The forward kernel's gaussian: f32 division, then exp."""
    d2 = np.asarray(d2, f32)
    return np.exp(np.negative(d2) / ras.two_sigma_sq(sigma))


def _g_bwd(d2, sigma):
    """The backward kernel's: the product by the f32 reciprocal, then exp."""
    inv = f32(1.0) / ras.two_sigma_sq(sigma)
    return np.exp(np.negative(np.asarray(d2, f32)) * inv)


def _kernel_d2(p, v):
    """(N, 2) f32 pixels and vertices -> the kernels' computed d2 (f32)."""
    p, v = torch.from_numpy(p), torch.from_numpy(v)
    p_sq = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
    v_sq = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
    cross = fma_f32(p[:, 1], v[:, 1], p[:, 0] * v[:, 0])
    return torch.clamp((p_sq + v_sq) - 2.0 * cross, min=0.0).numpy()


def test_exp_zero_is_where_f32_exp_vanishes():
    x0 = f32(ras.EXP_ZERO)
    assert float(x0) == ras.EXP_ZERO
    below = np.array([x0, np.nextafter(x0, f32(-np.inf)), f32(-110.0),
                      f32(-1e30), f32(-np.inf)], f32)
    assert (np.exp(below) == 0).all()
    assert (torch.exp(torch.from_numpy(below)) == 0).all()
    assert np.exp(np.nextafter(x0, f32(0.0))) > 0
    src = (Path(ras.__file__).parent.parent / "csrc" / "splat.cu").read_text()
    const = re.search(r"kExpZero = (-0x[0-9a-f.]+p\+\d+)f;", src).group(1)
    assert float.fromhex(const) == ras.EXP_ZERO


@pytest.mark.parametrize("sigma", SIGMAS)
def test_cut_vanishes_and_is_tight(sigma):
    cut = ras.cut_d2(sigma)
    assert float(f32(cut)) == cut
    assert _g_fwd(cut, sigma) == 0
    assert _g_fwd(np.nextafter(f32(cut), f32(np.inf)), sigma) == 0
    assert _g_fwd(f32(2 * cut), sigma) == 0
    # one f32 step below the cut the gaussian is still nonzero
    assert _g_fwd(np.nextafter(f32(cut), f32(0.0)), sigma) > 0
    # ~ -EXP_ZERO 2 sigma^2: 468 px^2 (21.6 px) at sigma 1.5
    np.testing.assert_allclose(cut, -ras.EXP_ZERO * 2 * sigma**2, rtol=1e-6)


@pytest.mark.parametrize("sigma,res", [(0.5, 20), (1.5, 112), (3.0, 144),
                                       (12.0, 112), (40.0, 64)])
def test_skip_margin_covers_the_computed_distance(sigma, res):
    """Pairs near the skip threshold and vertices at +-1e4 px: wherever the
    exact f64 distance reaches it, the kernels' f32 distance reaches the cut
    and both kernels' gaussians are exactly 0."""
    rng = np.random.RandomState(int(sigma * 10) + res)
    cut = ras.cut_d2(sigma)
    n = 20000
    p = (rng.randint(0, res, (n, 2)) + 0.5).astype(f32)
    # vertices at the threshold's radius from a pixel, +-1e-3 relative; a
    # quarter anywhere on and off the canvas; an eighth at +-1e4 px
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = np.sqrt(ras.skip_threshold(2 * res**2, cut, res)) * rng.uniform(
        0.999, 1.001, n)
    v = p + np.stack([np.cos(ang), np.sin(ang)], -1) * rad[:, None]
    v[: n // 4] = rng.uniform(-res, 2 * res, (n // 4, 2))
    v[n // 4: 3 * n // 8] = rng.choice([-1e4, 1e4], (n // 8, 2)) + rng.uniform(
        -res, res, (n // 8, 2))
    v = v.astype(f32)
    p64, v64 = p.astype(np.float64), v.astype(np.float64)
    exact = np.sum((p64 - v64) ** 2, -1)
    skip = exact >= ras.skip_threshold(np.sum(v64 * v64, -1), cut, res)
    d2 = _kernel_d2(p, v)
    assert skip.sum() > n // 4 and (~skip).sum() > n // 8
    assert (d2[skip] >= cut).all()
    assert (_g_fwd(d2[skip], sigma) == 0).all()
    assert (_g_bwd(d2[skip], sigma) == 0).all()
    # some skipped pairs lie within 1e-3 of the cut: the margin is tight
    assert (d2[skip] < cut * 1.001 + 2e-3 * res**2).any()


@pytest.mark.parametrize("res,sigma", [(48, 1.5), (40, 3.0), (24, 0.5)])
def test_skipped_pairs_change_no_mask_or_gradient(res, sigma):
    """The dense twin with the gaussians of every pair that the kernels skip
    set to 0 gives the twin's mask and autograd gradient bit for bit."""
    rng = np.random.RandomState(res)
    B, V = 2, 200
    v2d = rng.uniform(-0.5 * res, 1.5 * res, (B, V, 2))
    v2d[:, : V // 4] = res / 2 + rng.randn(B, V // 4, 2) * 0.08 * res
    v2d[:, ::8] = rng.choice([-1e4, 1e4], (B, len(range(0, V, 8)), 2))
    v2d = v2d.astype(f32)
    tgt = torch.from_numpy((rng.rand(B, res, res) > 0.5).astype(f32))
    pix = ras._pixel_grid(res, torch.float64).numpy()  # (P, 2)
    v64 = v2d.astype(np.float64)
    exact = np.sum((pix[None, :, None] - v64[:, None]) ** 2, -1)  # (B, P, V)
    thr = ras.skip_threshold(np.sum(v64 * v64, -1), ras.cut_d2(sigma), res)
    skip = torch.from_numpy(exact >= thr[:, None, :])
    assert 0 < int(skip.sum()) < skip.numel()

    def run(zero_skipped):
        v = torch.from_numpy(v2d).requires_grad_(True)
        g = ras.splat_gaussians(v, res, sigma)
        if zero_skipped:
            assert (g[skip] == 0).all()
            g = torch.where(skip, torch.zeros_like(g), g)
        mask = ras.silhouette_from_gaussians(g, res)
        (mask - tgt).abs().mean().backward()
        return mask.detach(), v.grad

    mask, grad = run(False)
    mask0, grad0 = run(True)
    assert torch.equal(mask, ras.splat_silhouette_plain(
        torch.from_numpy(v2d), res, sigma))
    assert torch.equal(mask0, mask)
    assert torch.equal(grad0, grad)
    assert float(grad.abs().max()) > 0
