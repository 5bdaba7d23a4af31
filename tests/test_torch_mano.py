"""Port parity: MANO model arrays, the pkl loader and ``mano_forward``
(``hands_tpu_torch.ops.mano`` against ``hands_tpu.ops.mano``).

Tolerances: model arrays bit-equal (same numpy seeds); posed vertices and
joints of f32 geometry to 1e-5 absolute.
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.ops import mano as jmano
from hands_tpu_torch.ops import mano as tmano

FIELDS = jmano.ManoModel._fields


@pytest.mark.parametrize("is_rhand", [True, False])
def test_synthetic_model_arrays_bit_equal(is_rhand):
    ref = jmano._synthetic_model(is_rhand)
    got = tmano.load_mano(is_rhand)
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("is_rhand", [True, False])
def test_pkl_loader_matches_jax(tmp_path, is_rhand):
    from scipy import sparse

    src = jmano._synthetic_model(is_rhand)
    rng = np.random.RandomState(7)
    data = {
        "v_template": np.asarray(src.v_template, np.float64),
        "shapedirs": np.asarray(src.shapedirs, np.float64),
        "posedirs": np.asarray(src.posedirs).T.reshape(778, 3, 135),
        "hands_mean": rng.randn(45) * 0.1,
        "J_regressor": sparse.csc_matrix(np.asarray(src.j_regressor,
                                                    np.float64)),
        "weights": np.asarray(src.lbs_weights, np.float64),
        "f": np.asarray(src.faces, np.uint32),
    }
    path = tmp_path / "MANO.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    ref = jmano._from_mano_pkl(str(path), is_rhand)
    got = tmano._from_mano_pkl(str(path), is_rhand)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("is_rhand", [True, False])
def test_mano_forward_matches_jax(is_rhand):
    rng = np.random.RandomState(8)
    B = 6
    betas = (rng.randn(B, 10) * 0.8).astype(np.float32)
    pose = (rng.randn(B, 45) * 0.4).astype(np.float32)
    glob = (rng.randn(B, 3) * 1.2).astype(np.float32)
    transl = (rng.randn(B, 3) * 0.1).astype(np.float32)
    ref = jmano.mano_forward(jmano.load_mano(is_rhand), jnp.asarray(betas),
                             jnp.asarray(pose), jnp.asarray(glob),
                             jnp.asarray(transl))
    got = tmano.mano_forward(tmano.load_mano(is_rhand),
                             torch.from_numpy(betas), torch.from_numpy(pose),
                             torch.from_numpy(glob), torch.from_numpy(transl))
    assert got.vertices.shape == (B, 778, 3)
    assert got.joints.shape == (B, 21, 3)
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(ref.vertices),
                               atol=1e-5)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                               atol=1e-5)


def test_flat_hand_mean_and_mano_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MANO_DIR", str(tmp_path))  # no pkl there: synthetic
    m = tmano.load_mano(True, flat_hand_mean=True)
    assert float(m.hand_mean.abs().sum()) == 0.0
    assert m.faces.dtype == torch.int32 and m.faces.shape == (1538, 3)
