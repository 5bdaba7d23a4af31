"""Port parity of ``train/losses.py``: every term of ``compute_loss_light``
and ``total_loss`` against the JAX package's on the same numpy predictions
and targets: all flags on, each supervision flag off in turn, partly valid
samples, and a batch with no valid sample (the zero guards). Tolerance: 1e-5
relative to max(|ref|, 1e-3) for each term and for the total; the gradient of
the total with respect to every prediction, 1e-5 of the leaf's largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_util import both
from hands_tpu.config import default_config as jax_config
from hands_tpu.data.synthetic import make_batch
from hands_tpu.ops import mano as jmano
from hands_tpu.train import losses as jloss
from hands_tpu.train.process import process_data_light as jax_process
from hands_tpu_torch.config import default_config
from hands_tpu_torch.train import losses as tloss

B, RES = 4, 32
ALL_ON = dict(use_grasp_loss=True, use_render_seg_loss=True,
              use_depth_loss=True, regress_center_corner=True,
              img_res=RES, img_res_ds=RES)
FLAGS = ("is_j2d_loss", "is_j3d_loss", "is_pose_loss", "is_beta_loss",
         "is_cam_loss", "is_grasp_loss", "is_mask_loss", "is_depth_loss")


def _case(seed=0):
    """Processed numpy targets and meta plus a random prediction dict."""
    cfg = jax_config("hands_light", **ALL_ON)
    batch = make_batch(cfg, B, seed=seed)
    _, targets, meta = jax_process(jmano.load_mano(True),
                                   jmano.load_mano(False), *batch, RES)
    targets = {k: np.array(v) for k, v in targets.items()}  # writable
    meta = {k: np.array(v) for k, v in meta.items()}
    rng = np.random.RandomState(seed + 1)
    f = np.float32

    def near(a, s):
        return (a + rng.randn(*a.shape) * s).astype(f)

    pred = {}
    for s in "rl":
        pred[f"mano.pose.{s}"] = rng.randn(B, 16, 3, 3).astype(f) * 0.5
        pred[f"mano.beta.{s}"] = near(targets[f"mano.beta.{s}"], 0.2)
        pred[f"mano.j2d.norm.{s}"] = near(
            targets[f"mano.j2d.norm.{s}"][..., :2], 0.1)
        pred[f"mano.j3d.cam.{s}"] = near(targets[f"mano.j3d.cam.{s}"], 0.02)
        pred[f"mano.cam_t.wp.{s}"] = near(targets[f"mano.cam_t.wp.{s}"], 0.3)
        pred[f"mano.cam_t.wp.init.{s}"] = near(
            targets[f"mano.cam_t.wp.{s}"], 0.5)
        pred[f"grasp.{s}"] = rng.randn(B, 9).astype(f)
        pred[f"render.{s}"] = rng.rand(B, RES, RES).astype(f)
        pred[f"depth.{s}"] = rng.rand(B, RES, RES).astype(f)
        pred[f"center.{s}"] = near(targets[f"center.{s}"], 0.1)
        pred[f"corner.{s}"] = near(targets[f"corner.{s}"], 0.1)
    return pred, targets, meta


def _variants():
    out = {"all_on": lambda t, m: None}
    for flag in FLAGS:
        out[f"off_{flag}"] = lambda t, m, flag=flag: m.update(
            {flag: np.zeros(B, np.float32)})

    def partly(t, m):
        t["right_valid"] = np.array([1, 0, 1, 0], np.float32)
        t["left_valid"] = np.array([0, 0, 1, 1], np.float32)
        t["is_valid"] = np.array([1, 1, 1, 0], np.float32)
        t["joints_valid_r"][:, ::3] = 0.0
        t["grasp_valid_l"] = np.array([1, 0, 0, 1], np.float32)
        t["render_valid_r"] = np.array([0, 1, 1, 0], np.float32)
        m["is_pose_loss"] = np.array([1, 0, 1, 1], np.float32)

    def none_valid(t, m):
        for k in ("is_valid", "right_valid", "left_valid", "grasp_valid_r",
                  "grasp_valid_l", "render_valid_r", "render_valid_l"):
            t[k] = np.zeros(B, np.float32)
        t["joints_valid_r"][:] = 0.0
        t["joints_valid_l"][:] = 0.0

    out["partly_valid"] = partly
    out["none_valid"] = none_valid
    return out


VARIANTS = _variants()


def _both_losses(pred, targets, meta, **cfg_kw):
    kw = dict(ALL_ON, **cfg_kw)
    jd = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    ref = jloss.compute_loss_light(jd(pred), jd(targets), jd(meta),
                                   jax_config("hands_light", **kw))
    td = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    tp = td(pred)
    for v in tp.values():
        v.requires_grad_(True)
    got = tloss.compute_loss_light(tp, td(targets), td(meta),
                                   default_config("hands_light", **kw))
    return ref, got, tp


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_terms_match_jax(variant):
    pred, targets, meta = _case()
    VARIANTS[variant](targets, meta)
    ref, got, _ = _both_losses(pred, targets, meta)
    assert list(ref) == list(got) and len(got) == 21
    for k, (v, w) in ref.items():
        gv, gw = got[k]
        assert gw == w, k
        assert gv.ndim == 0 and torch.isfinite(gv), k
        a = float(v)
        assert abs(float(gv.detach()) - a) <= 1e-5 * max(abs(a), 1e-3), (k, a)
    a = float(jloss.total_loss(ref))
    assert abs(float(tloss.total_loss(got).detach()) - a) <= 1e-5 * max(abs(a), 1e-3)
    if variant == "none_valid":
        hand_terms = [k for k in got if "depth" not in k]
        assert all(float(got[k][0].detach()) == 0.0 for k in hand_terms)
    if variant.startswith("off_"):
        assert sum(float(got[k][0].detach()) == 0.0 for k in got) >= 2


@pytest.mark.parametrize("flags", [
    dict(use_grasp_loss=False), dict(use_render_seg_loss=False),
    dict(use_depth_loss=False), dict(regress_center_corner=False),
    dict(use_grasp_loss=False, use_render_seg_loss=False,
         use_depth_loss=False, regress_center_corner=False)],
    ids=["no_grasp", "no_mask", "no_depth", "no_center", "bare"])
def test_loss_keys_follow_the_config(flags):
    pred, targets, meta = _case(seed=3)
    ref, got, _ = _both_losses(pred, targets, meta, **flags)
    assert list(ref) == list(got)
    a = float(jloss.total_loss(ref))
    assert abs(float(tloss.total_loss(got).detach()) - a) <= 1e-5 * max(abs(a), 1e-3)


@pytest.mark.parametrize("variant", ["all_on", "partly_valid", "none_valid"])
def test_loss_gradients_match_jax(variant):
    pred, targets, meta = _case(seed=5)
    VARIANTS[variant](targets, meta)
    _, got, tp = _both_losses(pred, targets, meta)
    tloss.total_loss(got).backward()
    cfg = jax_config("hands_light", **ALL_ON)
    jd = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    gref = jax.grad(lambda p: jloss.total_loss(jloss.compute_loss_light(
        p, jd(targets), jd(meta), cfg)))(jd(pred))
    for k, g in gref.items():
        a = np.asarray(g)
        b = tp[k].grad.numpy()
        assert np.isfinite(b).all(), k
        assert np.abs(b - a).max() <= 1e-5 * max(np.abs(a).max(), 1e-6), k


def test_vector_loss_zero_guard_is_a_tensor_where():
    """All samples invalid: zeros, not NaN, and no host read (the guard is a
    ``where`` on a tensor condition, so it works on a meta tensor too)."""
    p = torch.randn(3, 5, device="meta")
    out = tloss.vector_loss(p, torch.zeros_like(p),
                            torch.zeros(3, device="meta"))
    assert out.shape == (3, 5) and out.device.type == "meta"
    p = torch.full((2, 4), float("inf"))
    got = tloss.vector_loss(p, torch.zeros(2, 4), torch.zeros(2))
    assert torch.equal(got, torch.zeros(2, 4))
