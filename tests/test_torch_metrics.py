"""Port parity of ``train/metrics.py``: the five metrics and
``evaluate_metrics`` against the JAX package's on the same numpy predictions
and targets, with NaN in the same places. Tolerance on the finite entries:
1e-5 relative to max(|ref|, 1) (mm and pixels), 1e-4 for the
Procrustes-aligned metrics (an SVD per sample in each framework).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.train import metrics as jmet
from hands_tpu_torch.train import metrics as tmet

B = 6
SPECS = ["mrrpe.rl", "mpjpe.ra", "mpjpe.pa.ra", "pix_err", "pck"]


def _case(seed=0, joints3d_valid=False):
    rng = np.random.RandomState(seed)
    f = np.float32
    targets, pred = {}, {}
    for s in "rl":
        gt = (rng.randn(B, 21, 3) * 0.05).astype(f)
        gt[..., 2] += 0.6
        targets[f"mano.j3d.cam.{s}"] = gt
        pred[f"mano.j3d.cam.{s}"] = (gt + rng.randn(B, 21, 3) * 0.01).astype(f)
        g2 = (rng.rand(B, 21, 3) * 224).astype(f)
        targets[f"mano.j2d.{s}"] = g2
        pred[f"mano.j2d.{s}"] = (g2[..., :2] + rng.randn(B, 21, 2) * 8).astype(f)
        targets[f"joints_valid_{s}"] = (rng.rand(B, 21) > 0.2).astype(f)
    targets["is_valid"] = np.array([1, 1, 1, 0, 1, 1], f)
    targets["right_valid"] = np.array([1, 0, 1, 1, 0, 1], f)
    targets["left_valid"] = np.array([1, 1, 0, 1, 0, 1], f)
    if joints3d_valid:
        for s in "rl":
            jv = (rng.rand(B, 21) > 0.4).astype(f)
            jv[0, 0] = 0.0  # the root joint invalid: first valid joint roots
            jv[5] = 0.0  # a hand with no valid joint
            targets[f"joints3d_valid_{s}"] = jv
    return pred, targets


def _run_both(pred, targets, specs):
    jd = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    td = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    ref = jmet.evaluate_metrics(jd(pred), jd(targets), {}, specs)
    got = tmet.evaluate_metrics(td(pred), td(targets), {}, specs)
    return ref, got


def _assert_same(ref, got):
    assert list(ref.keys()) == list(got.keys())
    for k in ref:
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        ok = ~np.isnan(a)
        tol = 1e-4 if "/pa/" in k else 1e-5
        err = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(a[ok]), 1.0)
        assert err.size == 0 or err.max() <= tol, (k, err.max())


@pytest.mark.parametrize("spec", SPECS)
def test_metric_matches_jax(spec):
    pred, targets = _case()
    ref, got = _run_both(pred, targets, [spec])
    _assert_same(ref, got)
    first = np.asarray(next(iter(ref.values())))
    assert np.isnan(first).any() and not np.isnan(first).all()


def test_masked_procrustes_metrics_match_jax():
    pred, targets = _case(seed=1, joints3d_valid=True)
    ref, got = _run_both(pred, targets, ["mpjpe.pa.ra"])
    assert len(got) == 9
    _assert_same(ref, got)
    assert np.isnan(got["mpjpe/pa/ra/r"].numpy()[5])  # no valid joint
    assert got["mpjpe/pa/ra/r"].numpy()[1] == 0.0  # invalid hand scores 0


def test_evaluate_metrics_merges_every_spec():
    pred, targets = _case(seed=2)
    ref, got = _run_both(pred, targets, SPECS)
    _assert_same(ref, got)
    assert set(got) == {"mrrpe/r/l", "mpjpe/ra/h", "mpjpe/pa/ra/h",
                        "pix_err/r", "pix_err/l", "pix_err/h", "pck/5px",
                        "pck/10px", "pck/15px"}
    assert sorted(tmet.eval_fn_dict) == sorted(jmet.eval_fn_dict)


def test_all_invalid_batch_is_all_nan():
    pred, targets = _case(seed=3)
    targets["is_valid"] = np.zeros(B, np.float32)
    ref, got = _run_both(pred, targets, SPECS)
    _assert_same(ref, got)
    assert all(np.isnan(v.numpy()).all() for v in got.values())
