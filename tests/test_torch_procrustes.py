"""Port parity of ``ops/procrustes.py`` against the JAX package: the same
numpy point sets through ``similarity_align`` and ``similarity_align_masked``.

Tolerance: 1e-5 absolute on aligned points of unit scale (two f32 SVDs of a
3x3 matrix; observed 2.9e-6). A reflected set (the determinant fix must
fire), a set that is a similarity transform of the target (the alignment must
recover it), and degenerate sets (all points equal; collinear points, where R
is not unique but the aligned points are) are among the cases.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.ops import procrustes as jpro
from hands_tpu_torch.ops import procrustes as tpro

TOL = 1e-5


def _sets(seed=0, B=6, N=21):
    rng = np.random.RandomState(seed)
    S1 = rng.randn(B, N, 3).astype(np.float32)
    S2 = rng.randn(B, N, 3).astype(np.float32)
    # 1: S2 is S1 reflected (det of the correlation's rotation is -1)
    S2[1] = S1[1] * np.array([1.0, 1.0, -1.0], np.float32)
    # 2: S2 is a similarity transform of S1
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    S2[2] = 1.7 * S1[2] @ R.T + np.array([0.3, -0.2, 0.9], np.float32)
    # 3: all source points equal (zero variance)
    S1[3] = S1[3, :1]
    # 4: collinear source and target
    t = np.linspace(-1, 1, N, dtype=np.float32)[:, None]
    S1[4] = t * np.array([[1.0, 2.0, -1.0]], np.float32)
    S2[4] = t * np.array([[0.5, -1.0, 2.0]], np.float32) + 0.2
    return S1, S2


def test_similarity_align_matches_jax():
    S1, S2 = _sets()
    ref = np.asarray(jpro.similarity_align(jnp.asarray(S1), jnp.asarray(S2)))
    got = tpro.similarity_align(torch.from_numpy(S1),
                                torch.from_numpy(S2)).numpy()
    assert got.shape == ref.shape == S1.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    # the similarity transform is recovered; the reflection is not (det +1)
    np.testing.assert_allclose(got[2], S2[2], rtol=0, atol=1e-5)
    assert np.abs(got[1] - S2[1]).max() > 0.1


@pytest.mark.parametrize("case", ["random", "first_invalid", "none_valid"])
def test_similarity_align_masked_matches_jax(case):
    S1, S2 = _sets(seed=1)
    rng = np.random.RandomState(2)
    valid = (rng.rand(*S1.shape[:2]) > 0.3).astype(np.float32)
    if case == "first_invalid":
        valid[:, 0] = 0.0
    if case == "none_valid":
        valid[0] = 0.0
    ref = np.asarray(jpro.similarity_align_masked(
        jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(valid)))
    got = tpro.similarity_align_masked(
        torch.from_numpy(S1), torch.from_numpy(S2),
        torch.from_numpy(valid)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_masked_with_all_valid_equals_unmasked():
    S1, S2 = _sets(seed=3)
    a = tpro.similarity_align(torch.from_numpy(S1), torch.from_numpy(S2))
    b = tpro.similarity_align_masked(torch.from_numpy(S1),
                                     torch.from_numpy(S2),
                                     torch.ones(S1.shape[:2]))
    torch.testing.assert_close(a, b, rtol=0, atol=TOL)
