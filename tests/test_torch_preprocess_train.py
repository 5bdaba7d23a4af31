"""Port parity of train-mode preprocessing: the augmentation pieces of
``hands_tpu_torch.ops.preprocess`` and ``DevicePreprocessor(is_train=True)``
against the JAX package, with JAX's random draws fed to the port (the two
frameworks' generators give different numbers from one seed; the test
replicates the key splits of ``device_pipeline.py:_process_inner``,
``preprocess.py:augm_params`` and ``jitter_bbox``).

The port rotates with one gather pass; the JAX package's train path uses a
three-shear DFT rotation and keeps the gather (``rotate_patch_gather``) as
that rotation's oracle. So the rotation is held to the gather at 1e-4 on
[0, 1] images, and to the DFT rotation at the bounds tests/test_preprocess.py
holds between the two JAX functions (interpolation softness: median 0.02,
95th percentile 0.06 on the interior of a smooth image); the whole
preprocessor is held to the JAX one with its rotation taken through the
gather.

Tolerances: f32 geometry 1e-5 absolute; images 2e-4 after ImageNet
normalisation, as tests/test_torch_preprocess.py (XLA rewrites the sample
coordinates under jit); nearest-neighbour mask and depth crops may differ on
at most 1e-3 of their pixels (a sample coordinate within an ulp of a pixel
boundary), and inside the whole preprocessor on 5e-3: an unrotated crop of
an unscaled (egocam) record samples whole columns exactly on a boundary,
where the indicator weights take one neighbour or both depending on that ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.datasets import SyntheticRecordDataset as JaxSynthetic
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.ops import preprocess as jpp
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                  stack_records)
from hands_tpu_torch.ops import preprocess as tpp


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs six workers side by side, and eight threads
    each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


IMAGE_KEYS = ("img", "r_img", "l_img")
NEAREST_KEYS = ("render.r", "render.l", "depth.r", "depth.l")


def _augm_draws(key, B):
    """The raw draws behind ``jpp.augm_params(key, B, True, ...)``."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return {"flip_u": np.asarray(jax.random.uniform(k1, (B,))),
            "pn_u": np.asarray(jax.random.uniform(k2, (B, 3))),
            "rot_n": np.asarray(jax.random.normal(k3, (B,))),
            "rot_u": np.asarray(jax.random.uniform(k4, (B,))),
            "sc_n": np.asarray(jax.random.normal(k5, (B,)))}


def test_gaussian_blur_matches_jax():
    img = (np.random.RandomState(0).rand(2, 40, 56, 3) * 255).astype(np.float32)
    ref = np.asarray(jpp.gaussian_blur(jnp.asarray(img)))
    got = tpp.gaussian_blur(torch.from_numpy(img)).numpy()
    # five-term f32 sums in another order, on the 0..255 scale
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2e-4)
    assert abs(float(got[0, 0, 0, 0]) - float(img[0, 0, 0, 0])) > 1.0


def test_jitter_bbox_and_intrinsics_match_jax():
    rng = np.random.RandomState(1)
    B = 5
    bbox = np.concatenate([rng.uniform(0, 100, (B, 2)),
                           rng.uniform(20, 80, (B, 2))], -1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jpp.jitter_bbox(key, jnp.asarray(bbox)))
    got = tpp.jitter_bbox(torch.from_numpy(bbox),
                          draws=np.asarray(jax.random.uniform(key, (B, 2))))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[:, 2:], bbox[:, 2:])

    K = np.tile(np.asarray([[600.0, 0, 120], [0, 610.0, 100], [0, 0, 1]],
                           np.float32), (B, 1, 1))
    ref = np.asarray(jpp.jitter_intrinsics(key, jnp.asarray(K)))
    ks, kt = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(ks, (B,))),
             np.asarray(jax.random.uniform(kt, (B, 2))))
    Kt = torch.from_numpy(K)
    got = tpp.jitter_intrinsics(Kt, draws=draws).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_array_equal(Kt.numpy(), K)  # the input is not touched
    # its own generator: reproducible, inside the documented ranges
    a = tpp.jitter_intrinsics(Kt, generator=torch.Generator().manual_seed(3))
    b = tpp.jitter_intrinsics(Kt, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ratio = (a[:, 0, 0] / 600.0).numpy()
    assert np.all(ratio >= np.exp(-0.5) - 1e-6) and np.all(
        ratio <= np.exp(0.5) + 1e-6) and np.ptp(ratio) > 0


def test_augm_params_match_jax_and_their_distributions():
    B = 64
    key = jax.random.PRNGKey(11)
    ref = jpp.augm_params(key, B, True, 0.5, 0.4, 30.0, 0.25)
    got = tpp.augm_params(B, "cpu", True, 0.5, 0.4, 30.0, 0.25,
                          draws=_augm_draws(key, B))
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    ev = tpp.augm_params(3, "cpu")
    assert float(ev["flip"].sum()) == 0 and float(ev["rot"].abs().sum()) == 0
    assert bool((ev["sc"] == 1).all()) and bool((ev["pn"] == 1).all())
    g = tpp.augm_params(4000, "cpu", True, 0.3, 0.4, 30.0, 0.25,
                        generator=torch.Generator().manual_seed(0))
    assert abs(float(g["flip"].mean()) - 0.3) < 0.03
    assert abs(float((g["rot"] == 0).float().mean()) - 0.6) < 0.03
    assert float(g["rot"].abs().max()) <= 60.0
    assert 0.75 <= float(g["sc"].min()) and float(g["sc"].max()) <= 1.25
    assert 0.6 <= float(g["pn"].min()) and float(g["pn"].max()) <= 1.4


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_rotation_matches_the_gather_oracle(method):
    rng = np.random.RandomState(2)
    img = rng.rand(3, 48, 48, 3).astype(np.float32)
    rot = np.asarray([25.0, -40.0, 0.0], np.float32)
    ref = np.asarray(jpp.rotate_patch_gather(jnp.asarray(img),
                                             jnp.asarray(rot), method))
    got = tpp.rotate_patch(torch.from_numpy(img), torch.from_numpy(rot),
                           method).numpy()
    if method == "bilinear":
        np.testing.assert_allclose(got, ref, atol=1e-4)
    else:
        assert np.mean(got != ref) <= 1e-3
    np.testing.assert_allclose(got[2, 1:-1, 1:-1], img[2, 1:-1, 1:-1],
                               atol=1e-6)  # zero rotation is the identity


def test_rotation_against_the_dft_shear_rotation():
    """The JAX train path's rotation (three DFT shears) against the port's
    gather, at the bounds tests/test_preprocess.py holds between the JAX
    package's own two rotations."""
    img = np.outer(np.sin(np.arange(224) / 9.0),
                   np.cos(np.arange(224) / 7.0)).astype(np.float32)
    img = np.tile(np.stack([img, img * 0.5, img * 0.2], -1)[None],
                  (2, 1, 1, 1))
    rot = np.asarray([25.0, -40.0], np.float32)
    ref = np.asarray(jpp.rotate_patch(jnp.asarray(img), jnp.asarray(rot)))
    got = tpp.rotate_patch(torch.from_numpy(img), torch.from_numpy(rot)).numpy()
    d = np.abs(ref - got)[:, 20:-20, 20:-20]
    assert np.median(d) < 0.02
    assert np.percentile(d, 95) < 0.06


def test_rgb_crop_augment_and_mask_crop_with_rotation():
    rng = np.random.RandomState(3)
    B, res = 3, 64
    imgs = (rng.rand(B, 90, 120, 3) * 255).astype(np.float32)
    masks = rng.choice([0, 127, 255], (B, 90, 120)).astype(np.float32)
    center = rng.uniform(40, 70, (B, 2)).astype(np.float32)
    dim = rng.uniform(0.3, 0.5, B).astype(np.float32)
    augm = {"sc": np.asarray([1.0, 1.2, 0.8], np.float32),
            "rot": np.asarray([0.0, 33.0, -51.0], np.float32),
            "pn": rng.uniform(0.6, 1.4, (B, 3)).astype(np.float32)}
    aj = {k: jnp.asarray(v) for k, v in augm.items()}
    at = {k: torch.from_numpy(v) for k, v in augm.items()}
    args_j = [jnp.asarray(a) for a in (center, dim)]
    args_t = [torch.from_numpy(a) for a in (center, dim)]
    orig = jpp.rotate_patch
    jpp.rotate_patch = jpp.rotate_patch_gather
    try:
        ref = np.asarray(jpp.rgb_crop_augment(jnp.asarray(imgs), *args_j, aj,
                                              res))
        ref_m = np.asarray(jpp.mask_crop(jnp.asarray(masks), *args_j, aj, res))
    finally:
        jpp.rotate_patch = orig
    got = tpp.rgb_crop_augment(torch.from_numpy(imgs), *args_t, at, res,
                               antialias=True, apply_rot=True).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)  # [0, 1] scale
    got_m = tpp.mask_crop(torch.from_numpy(masks), *args_t, at, res,
                          apply_rot=True).numpy()
    assert got_m.shape == ref_m.shape == (B, res, res, 1)
    assert np.mean(got_m != ref_m) <= 1e-3
    assert tpp._rot_margin_res(224) == jpp._rot_margin_res(224) == 318


def _records(n, with_maps):
    cfg = jax_config("hands_light")
    recs = [JaxSynthetic(cfg, "train", length=n)[i] for i in range(n)]
    rng = np.random.RandomState(5)
    for i, r in enumerate(recs):
        r.is_egocam = float(i == 1)
        if with_maps:
            h, w = r.image.shape[:2]
            r.mask = rng.choice([0, 127, 255], (h, w)).astype(np.uint8)
            r.depth = rng.uniform(0.2, 1.0, (h, w)).astype(np.float32)
            r.mask_valid_r = r.mask_valid_l = 1.0
    return recs


@pytest.mark.parametrize("with_maps", [False, True])
def test_train_mode_preprocessor_matches_jax(monkeypatch, with_maps):
    B = 6
    kw = dict(flip_prob=0.5, img_res=96, img_res_ds=64,
              use_depth_loss=with_maps)
    recs = _records(B, with_maps)
    monkeypatch.setattr(jpp, "rotate_patch", jpp.rotate_patch_gather)
    key = jax.random.PRNGKey(3)
    ref = JaxPre(jax_config("hands_light", **kw), is_train=True)(
        jax_stack(recs), key)
    k_aug, k_r, k_l = jax.random.split(key, 3)
    draws = {"augm": _augm_draws(k_aug, B),
             "jitter_r": np.asarray(jax.random.uniform(k_r, (B, 2))),
             "jitter_l": np.asarray(jax.random.uniform(k_l, (B, 2)))}
    pre = DevicePreprocessor(default_config("hands_light", **kw),
                             is_train=True, device="cpu")
    got = pre(stack_records(recs), draws=draws)
    flips = np.asarray(ref[2]["is_flipped"])
    rots = np.asarray(ref[2]["rot_angle"])
    assert 0 < flips.sum() < B and np.count_nonzero(rots) >= 1
    for r, g in zip(ref, got):
        assert set(r) == set(g), set(r) ^ set(g)
        for k in r:
            a = np.asarray(r[k])
            b = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert a.shape == b.shape, (k, a.shape, b.shape)
            if k in NEAREST_KEYS:
                assert np.mean(np.abs(a - b) > 1e-6) <= 5e-3, k
                continue
            atol = 2e-4 if k in IMAGE_KEYS else 1e-5
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=atol, err_msg=k)
    # its own generator: reproducible, and another seed draws otherwise
    a = pre(stack_records(recs), generator=torch.Generator().manual_seed(1))
    b = pre(stack_records(recs), generator=torch.Generator().manual_seed(1))
    c = pre(stack_records(recs), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a[0]["img"], b[0]["img"], rtol=0, atol=0)
    assert not torch.equal(a[2]["rot_angle"], c[2]["rot_angle"])


def test_pcl_builds_and_runs_in_train_mode():
    """``pcl`` in train mode on its own generator: flipped crops, rotations
    a hand, reproducible from the seed (test_torch_pcl.py holds it against
    JAX with JAX's draws)."""
    B = 4
    cfg = default_config("hands_light", pos_enc="pcl", flip_prob=0.5,
                         img_res=96, img_res_ds=64)
    pre = DevicePreprocessor(cfg, is_train=True, device="cpu")
    stacked = stack_records(_records(B, False))
    a = pre(stacked, generator=torch.Generator().manual_seed(1))
    b = pre(stacked, generator=torch.Generator().manual_seed(1))
    assert a[0]["r_img"].shape == (B, 64, 64, 3)
    assert a[0]["r_rot"].shape == a[0]["l_rot"].shape == (B, 3, 3)
    assert bool(torch.isfinite(a[0]["l_img"]).all())
    for k in ("r_img", "l_img", "r_rot"):
        assert torch.equal(a[0][k], b[0][k]), k
