"""Port parity of ``data/synthetic.py``: ``make_batch`` and
``SyntheticDataset`` key by key against the JAX package's, same seed.

The numpy draws come in the same order, so everything drawn (poses, shapes,
images' noise, grasp labels, masks) is bit-equal; what passes through MANO
forward kinematics (3D joints, 2D keypoints, boxes, angles, the blobs in the
images) agrees to 1e-5 absolute in metres and normalised units and 2e-3 in
pixels (boxes), the distance between the two packages' f32 MANO passes.
"""

import numpy as np
import pytest
import torch

from hands_tpu.config import default_config as jax_config
from hands_tpu.data import synthetic as jsyn
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data import synthetic as tsyn

DRAWN = {"mano.pose.r", "mano.pose.l", "mano.beta.r", "mano.beta.l",
         "grasp.r", "grasp.l", "render.r", "render.l", "depth.r", "depth.l"}
PIXELS = {"r_bbox", "l_bbox"}

CASES = {
    "default": {},
    "depth_center": dict(use_depth_loss=True, regress_center_corner=True),
    "bare": dict(use_grasp_loss=False, use_render_seg_loss=False),
}


def _compare(ref, got):
    for r, g in zip(ref, got):
        assert list(r.keys()) == list(g.keys())
        for k in r:
            a, b = np.asarray(r[k]), np.asarray(g[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if k in DRAWN or a.dtype.kind == "i":
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                tol = 2e-3 if k in PIXELS else 1e-5
                np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_batch_matches_jax(case):
    kw = dict(img_res=64, img_res_ds=64, **CASES[case])
    ref = jsyn.make_batch(jax_config("hands_light", **kw), 3, seed=5,
                          np_arrays=True)
    got = tsyn.make_batch(default_config("hands_light", **kw), 3, seed=5,
                          np_arrays=True)
    _compare(ref, got)


def test_make_batch_tensors_on_the_named_device():
    cfg = default_config("hamer_light", img_res=64, img_res_ds=64)
    inputs, targets, meta = tsyn.make_batch(cfg, 2, seed=1, device="cpu")
    ref = tsyn.make_batch(cfg, 2, seed=1, np_arrays=True)
    for d, r in zip((inputs, targets, meta), ref):
        for k, v in d.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu", k
            np.testing.assert_array_equal(v.numpy(), r[k], err_msg=k)
    assert targets["grasp.r"].dtype == torch.int32
    assert meta["is_mask_loss"].sum() == 2


def test_make_batch_defaults_to_the_card():
    cfg = default_config("hands_light", img_res=32, img_res_ds=32)
    if torch.cuda.is_available():
        assert tsyn.make_batch(cfg, 1)[0]["img"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tsyn.make_batch(cfg, 1)


def test_synthetic_dataset_matches_jax():
    kw = dict(img_res=48, img_res_ds=48)
    ref = list(jsyn.SyntheticDataset(jax_config("hands_light", **kw), 2, 2,
                                     seed=3))
    ds = tsyn.SyntheticDataset(default_config("hands_light", **kw), 2, 2,
                               seed=3)
    got = list(ds)
    assert len(ds) == len(got) == 2
    for r, g in zip(ref, got):
        _compare(r, g)
    assert not np.array_equal(got[0][0]["img"], got[1][0]["img"])
