"""Port parity: eval-mode ``DevicePreprocessor`` and its ``ops/preprocess``
pieces (``hands_tpu_torch`` against ``hands_tpu``'s jitted ``_process``).

Records are built in numpy the way the demo builds them (mixed image sizes
zero-padded to one shape, provided or missing hand boxes, weak-persp or
given focal), plus GT-joint-box records.

Tolerances: geometry (boxes, normalised keypoints, KPE angles, poses) to
1e-5 absolute; intrinsics to 1e-6 relative. Resampled images to 2e-4
absolute after ImageNet normalisation (4.5e-5 on the [0, 1] scale, 1/87 of
one uint8 level): under jit XLA rewrites the crop's sample coordinates
(``/224`` as ``*(1/224)``, ``s*112`` as ``size*0.5``, fused multiply-adds),
so a coordinate lands one f32 ulp (1.5e-5 px near x=150) away and a pixel
moves by up to 255 ulp; JAX's own jitted and eager resamples differ by that
much.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.data.records import Record, default_flags
from hands_tpu.ops import preprocess as jpp
from hands_tpu_torch.cli.demo import (make_record, pad_to_common_size,
                                      serving_config)
from hands_tpu_torch.data.device_pipeline import DevicePreprocessor
from hands_tpu_torch.data.device_pipeline import stack_records
from hands_tpu_torch.ops import preprocess as tpp

IMAGE_KEYS = ("img", "r_img", "l_img")


def _demo_records(rng):
    sizes = [(240, 320), (300, 260), (180, 200), (256, 256)]
    # fractional corners: a corner that maps exactly onto an integer patch
    # pixel is floored on either side of it by one f32 ulp of difference
    boxes = [([20.3, 30.6, 150.2, 170.7], [160.4, 40.1, 300.3, 200.8]),
             (None, [10.2, 10.7, 90.4, 120.1]),
             ([5.6, 5.3, 60.1, 80.9], None),
             (None, None)]
    recs = []
    for i, ((h, w), (rb, lb)) in enumerate(zip(sizes, boxes)):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        box = (lambda b: None if b is None else np.asarray(b, np.float32))
        recs.append(make_record(f"img{i}.png", img, box(rb), box(lb),
                                focal=None if i % 2 == 0 else 700.0 + i))
    pad_to_common_size(recs)
    return recs


def _gt_joint_records(rng):
    recs = []
    for i in range(3):
        img = rng.randint(0, 256, (200, 240, 3), np.uint8)
        j2d_r = np.concatenate([rng.uniform(40, 180, (21, 2)),
                                np.ones((21, 1))], -1).astype(np.float32)
        j2d_l = np.concatenate([rng.uniform(20, 200, (21, 2)),
                                np.ones((21, 1))], -1).astype(np.float32)
        jv_l = (rng.rand(21) > 0.3).astype(np.float32) if i else \
            np.zeros(21, np.float32)  # no valid joint: full-image box
        K = np.asarray([[600.0, 0, 120], [0, 600.0, 100], [0, 0, 1]],
                       np.float32)
        recs.append(Record(
            imgname=f"gt{i}", image=img, K=K, j2d_r=j2d_r, j2d_l=j2d_l,
            j3d_r=rng.randn(21, 3).astype(np.float32),
            pose_r=(rng.randn(48) * 0.5).astype(np.float32),
            beta_l=rng.randn(10).astype(np.float32),
            joints_valid_l=jv_l, is_egocam=float(i == 1),
            use_gt_k=None if i == 2 else 1.0, loss_flags=default_flags(),
            dataset="test"))
    return recs


@pytest.mark.parametrize("which", ["demo", "gt_joints"])
def test_device_preprocessor_matches_jax(which):
    rng = np.random.RandomState(0)
    recs = _demo_records(rng) if which == "demo" else _gt_joint_records(rng)
    cfg = serving_config("hamer_light", "float32", False)
    ref = JaxPre(cfg, is_train=False)(jax_stack(recs), jax.random.PRNGKey(0))
    got = DevicePreprocessor(cfg, is_train=False, device="cpu")(
        stack_records(recs))
    for r, g in zip(ref, got):
        assert set(r) == set(g), set(r) ^ set(g)
        for k in r:
            a = np.asarray(r[k])
            b = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert a.shape == b.shape, (k, a.shape, b.shape)
            atol = 2e-4 if k in IMAGE_KEYS else 1e-5
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=atol,
                                       err_msg=k)


def test_stack_records_matches_jax():
    recs = _demo_records(np.random.RandomState(1))
    ref, got = jax_stack(recs), stack_records(recs)
    assert set(ref) == set(got)
    for k in ref:
        if isinstance(ref[k], list):
            assert ref[k] == got[k]
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype


def test_crop_resize_and_j2d_transform():
    rng = np.random.RandomState(2)
    B = 3
    imgs = (rng.rand(B, 50, 70, 3) * 255).astype(np.float32)
    cx, cy = rng.uniform(10, 60, B), rng.uniform(10, 40, B)
    size = rng.uniform(20, 90, B)
    args = [a.astype(np.float32) for a in (cx, cy, size)]
    ref = np.asarray(jpp.crop_resize_separable(
        jnp.asarray(imgs), *map(jnp.asarray, args), 32))
    got = tpp.crop_resize_separable(
        torch.from_numpy(imgs), *map(torch.from_numpy, args), 32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)  # 0..255 pixel scale

    kp = np.concatenate([rng.uniform(0, 70, (B, 21, 2)),
                         np.ones((B, 21, 1))], -1).astype(np.float32)
    center = np.stack([cx, cy], -1).astype(np.float32)
    dim = (size / 200).astype(np.float32)
    augm_j = {"sc": jnp.ones(B), "rot": jnp.asarray([0.0, 10.0, -30.0])}
    augm_t = {"sc": torch.ones(B), "rot": torch.tensor([0.0, 10.0, -30.0])}
    ref = np.asarray(jpp.j2d_crop_transform(
        jnp.asarray(kp), jnp.asarray(center), jnp.asarray(dim), augm_j, 224))
    got = tpp.j2d_crop_transform(
        torch.from_numpy(kp), torch.from_numpy(center), torch.from_numpy(dim),
        augm_t, 224).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_pcl_builds_and_runs_in_eval_mode():
    """Every ``pos_enc`` mode builds a preprocessor in both modes; ``pcl``
    runs in eval mode: perspective crops of the configured size and a
    rotation a hand (test_torch_pcl.py holds them against JAX)."""
    cfg = serving_config()
    pcl = cfg.replace(pos_enc="pcl")
    assert DevicePreprocessor(cfg, is_train=True, device="cpu").is_train
    assert DevicePreprocessor(pcl, is_train=True, device="cpu").is_train
    recs = _demo_records(np.random.RandomState(2))
    inputs, targets, meta = DevicePreprocessor(pcl, is_train=False,
                                               device="cpu")(
        stack_records(recs))
    B, res = len(recs), pcl.img_res_ds
    assert inputs["r_img"].shape == inputs["l_img"].shape == (B, res, res, 3)
    for side in ("r", "l"):
        R = inputs[f"{side}_rot"]
        assert R.shape == (B, 3, 3)
        torch.testing.assert_close(R @ R.transpose(1, 2),
                                   torch.eye(3).expand(B, 3, 3),
                                   rtol=0, atol=1e-6)
    assert bool(torch.isfinite(inputs["r_img"]).all())
