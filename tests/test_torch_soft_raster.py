"""Port parity of ``ops/rasterizer.py:soft_raster_silhouette`` against the
JAX package's on the same numpy meshes: a MANO-sized random mesh (778
vertices, 1538 faces, both windings, so the last face chunk is ragged) and a
single triangle. Tolerance: masks 2e-5 absolute (the bound
test_torch_rasterizer.py holds the splat to), vertex gradients 1e-4 of the
largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.ops import rasterizer as jras
from hands_tpu_torch.ops import rasterizer as tras


def _mesh(seed, V=778, F=1538, B=2):
    rng = np.random.RandomState(seed)
    verts = rng.randn(B, V, 3).astype(np.float32) * 0.008
    # the other samples: the first mesh shrunk, shifted and jittered
    for b in range(1, B):
        verts[b] = verts[0] * 0.7 + 0.004 * b + rng.randn(V, 3) * 2e-4
    verts[..., 2] += 0.5
    # small triangles, as on a hand: a vertex and its two nearest neighbours
    anchor = rng.randint(0, V, F)
    d = np.linalg.norm(verts[0, anchor, None, :2] - verts[0, None, :, :2],
                       axis=-1)
    near = np.argsort(d, axis=1)[:, 1:3]
    faces = np.concatenate([anchor[:, None], near], -1).astype(np.int32)
    K = np.tile(np.array([[600.0, 0, 28], [0, 600.0, 28], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    return verts, faces, K


@pytest.mark.parametrize("render_res,chunk", [(None, 128), (28, 500)])
def test_soft_raster_matches_jax(render_res, chunk):
    verts, faces, K = _mesh(0)
    ref = np.asarray(jras.soft_raster_silhouette(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(K), 56,
        sigma_px=1.0, render_res=render_res, face_chunk=chunk))
    got = tras.soft_raster_silhouette(
        torch.from_numpy(verts), torch.from_numpy(faces),
        torch.from_numpy(K), 56, sigma_px=1.0, render_res=render_res,
        face_chunk=chunk).numpy()
    assert got.shape == ref.shape == (2, 56, 56)
    assert got.std() > 0.01 and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_soft_raster_gradient_matches_jax():
    verts, faces, K = _mesh(1, V=60, F=90)
    rng = np.random.RandomState(2)
    cot = rng.randn(2, 56, 56).astype(np.float32)
    gref = np.asarray(jax.grad(lambda v: jnp.sum(jras.soft_raster_silhouette(
        v, jnp.asarray(faces), jnp.asarray(K), 56) * cot))(jnp.asarray(verts)))
    v = torch.from_numpy(verts).requires_grad_(True)
    (tras.soft_raster_silhouette(v, torch.from_numpy(faces),
                                 torch.from_numpy(K), 56)
     * torch.from_numpy(cot)).sum().backward()
    assert np.isfinite(v.grad.numpy()).all()
    assert np.abs(v.grad.numpy() - gref).max() <= 1e-4 * np.abs(gref).max()


def test_soft_raster_covers_triangle_interior_either_winding():
    verts = np.array([[[-0.05, -0.05, 0.5], [0.05, -0.05, 0.5],
                       [0.0, 0.05, 0.5]]], np.float32)
    K = np.array([[[500.0, 0, 56], [0, 500.0, 56], [0, 0, 1]]], np.float32)
    for faces in ([[0, 1, 2]], [[0, 2, 1]]):
        mask = tras.soft_raster_silhouette(
            torch.from_numpy(verts), torch.tensor(faces),
            torch.from_numpy(K), 112).numpy()[0]
        assert mask[40, 56] > 0.9 and mask[100, 5] < 1e-3
