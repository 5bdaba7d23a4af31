"""Port parity of the splat silhouette (K2): ``hands_tpu_torch.ops.rasterizer``
against ``hands_tpu.ops.rasterizer`` (``splat_silhouette``,
``render_silhouette``) and against ``splat_silhouette_fused`` of
``hands_tpu.ops.rasterizer_pallas`` with its Pallas kernels in interpret
mode, as tests/test_rasterizer_pallas.py runs them. Inputs from a numpy seed.

Tolerances: masks 2e-5 absolute, gradients ``atol=1e-6, rtol=1e-3`` (the
bounds of tests/test_rasterizer_pallas.py: the pair distance is formed as
|p|^2 + |v|^2 - 2 p.v, which cancels, and the sum over vertices runs in
another order). The CUDA kernels cannot run here; on a CPU tensor the wrapper
runs the twin and counts no launch.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.ops import rasterizer as jras
from hands_tpu.ops import rasterizer_pallas as jrp
from hands_tpu_torch.ops import rasterizer as tras


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels in interpreter mode on the CPU."""
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jrp.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def _scene(B, V, img_res, seed):
    """Camera-space vertices that project inside the image, and intrinsics."""
    rng = np.random.RandomState(seed)
    f = rng.uniform(300, 600, B).astype(np.float32)
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, 0, 2] = K[:, 1, 2] = img_res / 2
    K[:, 2, 2] = 1.0
    z = rng.uniform(0.4, 0.8, (B, V, 1)).astype(np.float32)
    centre = rng.uniform(0.25, 0.75, (B, 1, 2)) * img_res
    px = centre + rng.randn(B, V, 2) * img_res * 0.08
    xy = (px - img_res / 2) / f[:, None, None] * z
    return np.concatenate([xy, z], -1).astype(np.float32), K


@pytest.mark.parametrize("res,sigma,V", [(32, 2.0, 50), (20, 1.5, 50),
                                         (16, 2.0, 20)])
def test_twin_matches_pallas_kernel_forward(interpret_mode, res, sigma, V):
    rng = np.random.RandomState(res)
    v2d = (rng.rand(2, V, 2) * res).astype(np.float32)
    before = dict(tras.launches)
    got = tras.splat_silhouette_fused(torch.from_numpy(v2d), res, sigma)
    assert tras.launches == before  # CPU: the twin ran, no kernel
    assert got.shape == (2, res, res)
    ref = jrp.splat_silhouette_fused(jnp.asarray(v2d), res, sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    assert float(got.max()) > 0.5  # not an empty image


@pytest.mark.parametrize("img_res,render_res,sigma", [
    (64, None, 3.0), (64, 32, 3.0), (224, 112, 3.0), (48, 20, 2.0)])
def test_splat_silhouette_matches_jax(img_res, render_res, sigma):
    verts, K = _scene(3, 778, img_res, seed=img_res)
    ref = jras.splat_silhouette(jnp.asarray(verts), jnp.asarray(K), img_res,
                                sigma_px=sigma, render_res=render_res)
    got = tras.splat_silhouette(torch.from_numpy(verts), torch.from_numpy(K),
                                img_res, sigma_px=sigma,
                                render_res=render_res)
    assert got.shape == (3, img_res, img_res)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("img_res", [64, 224])
def test_render_silhouette_matches_jax(img_res):
    """The model's call (224^2 image, 112^2 render, sigma 1.5 px there) and a
    small one. At 224 the jitted JAX function itself moves by 5.8e-4 against
    its own op-by-op evaluation: inside the compiled fusion XLA:CPU forms the
    two-term product p.v with other fused multiply-adds, and at coordinates
    near 112 the cancellation in |p|^2 + |v|^2 - 2 p.v amplifies one rounding
    to ~1e-3 of a squared pixel. So at 224 the 2e-5 bound is held against the
    op-by-op evaluation, and the compiled one is held to 2e-3."""
    verts, K = _scene(2, 778, img_res, seed=7)
    faces = np.zeros((1538, 3), np.int32)
    args = (jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(K), img_res)
    got = tras.render_silhouette(torch.from_numpy(verts),
                                 torch.from_numpy(faces),
                                 torch.from_numpy(K), img_res)
    assert got.shape == (2, img_res, img_res)
    assert float(got.max()) > 0.9 and float(got.min()) < 1e-3
    compiled = np.asarray(jras.render_silhouette(*args))
    if img_res == 64:
        np.testing.assert_allclose(got.numpy(), compiled, atol=2e-5)
        return
    np.testing.assert_allclose(got.numpy(), compiled, atol=2e-3)
    with jax.disable_jit():
        op_by_op = np.asarray(jras.render_silhouette(*args))
    np.testing.assert_allclose(got.numpy(), op_by_op, atol=2e-5)


def test_twin_gradient_matches_jax_grad(interpret_mode):
    """The twin's autograd against ``jax.grad`` of the XLA splat and of the
    Pallas custom VJP, under an L1 mask loss."""
    res, sigma = 16, 2.0
    rng = np.random.RandomState(3)
    v2d = (rng.rand(2, 20, 2) * res).astype(np.float32)
    tgt = (rng.rand(2, res, res) > 0.5).astype(np.float32)

    def xla_splat(v):
        pix = jnp.asarray(jrp._pixel_grid(res))
        d2 = (jnp.sum(pix * pix, -1)[None, :, None]
              + jnp.sum(v * v, -1)[:, None, :]
              - 2 * jnp.einsum("pc,bvc->bpv", pix, v))
        g = jnp.exp(-jnp.maximum(d2, 0.0) / (2 * sigma * sigma))
        lm = jnp.sum(jnp.log1p(-jnp.clip(g, 0, 1 - 1e-6)), -1)
        return (1 - jnp.exp(lm)).reshape(v.shape[0], res, res)

    g_xla = jax.grad(lambda v: jnp.abs(xla_splat(v) - tgt).mean())(
        jnp.asarray(v2d))
    g_pallas = jax.grad(lambda v: jnp.abs(
        jrp.splat_silhouette_fused(v, res, sigma) - tgt).mean())(
            jnp.asarray(v2d))
    v = torch.from_numpy(v2d).requires_grad_(True)
    (tras.splat_silhouette_fused(v, res, sigma)
     - torch.from_numpy(tgt)).abs().mean().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_xla),
                               atol=1e-6, rtol=1e-3)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_pallas),
                               atol=1e-6, rtol=1e-3)
    assert float(v.grad.abs().max()) > 1e-4


def test_render_gradient_reaches_vertices():
    """Through projection, scale and the bilinear resize, against
    ``jax.grad`` of the JAX ``splat_silhouette``."""
    verts, K = _scene(2, 60, 48, seed=9)
    tgt = (np.random.RandomState(10).rand(2, 48, 48) > 0.5).astype(np.float32)
    g_ref = jax.grad(lambda v: jnp.abs(jras.splat_silhouette(
        v, jnp.asarray(K), 48, 3.0, 24) - tgt).mean())(jnp.asarray(verts))
    v = torch.from_numpy(verts).requires_grad_(True)
    (tras.splat_silhouette(v, torch.from_numpy(K), 48, 3.0, 24)
     - torch.from_numpy(tgt)).abs().mean().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_ref),
                               atol=1e-6, rtol=1e-3)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel or twin"):
        tras.splat_silhouette_fused(torch.zeros((1, 4, 2), device="meta"),
                                    8, 1.0)
