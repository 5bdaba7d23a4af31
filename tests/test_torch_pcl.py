"""Port parity of ``pcl`` preprocessing (perspective crop layers):
``hands_tpu_torch.ops.preprocess`` (``_pcl_rotation_from_position``,
``_pcl_virtual_intrinsics``, ``warp_homography``, ``pcl_crop``) and
``DevicePreprocessor(pos_enc="pcl")`` in eval and train mode against the
JAX package on the same numpy inputs, then the tiny WildHands model of each
package fed by the port's ``pcl`` preprocessing.

Tolerances: rotations and virtual intrinsics (f32) 1e-5; the crops 2e-4
on their [0, 1] scale. Under jit XLA computes ``1 / sqrt`` as its own
``rsqrt``, which rounds R one ulp off (op by op the rotations are
bit-equal), and the homography's sample coordinates (pixels near 220) land
a few ulps apart: a random uint8 image moves by up to 5e-5 there, 2.4e-4
after ImageNet normalisation. The normalised patch ``img`` and every other
key stay at tests/test_torch_preprocess.py's tolerances (2e-4 after
normalisation, geometry 1e-5). Model predictions: 1e-4 of max(|ref|, 1), as
tests/test_torch_hands_light.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.config import default_config as jax_config
from hands_tpu.data.device_pipeline import DevicePreprocessor as JaxPre
from hands_tpu.data.device_pipeline import stack_records as jax_stack
from hands_tpu.ops import preprocess as jpp
from hands_tpu_torch.config import default_config
from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                  stack_records)
from hands_tpu_torch.ops import preprocess as tpp
from test_torch_hands_light import RTOL, max_rel, records, run_pair
from test_torch_preprocess_train import _augm_draws
from test_torch_preprocess_train import _records as train_records


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the module, its module-scoped fixtures
    included: the suite runs six workers side by side, and eight threads
    each stall one another at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GEOM = 1e-5
CROP = 2e-4  # on the [0, 1] scale
CROP_KEYS = ("r_img", "l_img")
IMAGE_KEYS = ("img",) + CROP_KEYS


def _boxes_and_intrinsics(seed, B, res):
    """Hand boxes across a (res x res) patch (some past its edges, one
    thinner than a pixel) and patch intrinsics with an off-centre principal
    point."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-10, res - 20, B)
    y0 = rng.uniform(-10, res - 20, B)
    w, h = rng.uniform(4, res / 2, B), rng.uniform(4, res / 2, B)
    w[0] = 0.4
    box = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = rng.uniform(0.8, 3.0, B) * res
    K[:, 0, 2] = res / 2 + rng.randn(B) * 4
    K[:, 1, 2] = res / 2 + rng.randn(B) * 4
    K[:, 2, 2] = 1.0
    return box, K


def _rays(seed, B):
    rng = np.random.RandomState(seed)
    pos = np.concatenate([rng.randn(B, 2) * 0.5, np.ones((B, 1))], -1)
    return pos.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_and_virtual_intrinsics_match_jax(seed):
    B = 64
    pos = _rays(seed, B)
    box, K = _boxes_and_intrinsics(seed, B, 224)
    wh = np.maximum(box[:, 2:] - box[:, :2], 1.0)
    R = tpp._pcl_rotation_from_position(torch.from_numpy(pos)).numpy()
    for fn in (jpp._pcl_rotation_from_position,
               jax.jit(jpp._pcl_rotation_from_position)):
        np.testing.assert_allclose(R, np.asarray(fn(pos)), rtol=0, atol=GEOM)
    # a rotation: orthonormal with determinant 1, its z axis along the ray
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)
    ray = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    np.testing.assert_allclose(R[:, :, 2], ray, atol=1e-6)
    Kv = tpp._pcl_virtual_intrinsics(torch.from_numpy(pos),
                                     torch.from_numpy(K),
                                     torch.from_numpy(wh)).numpy()
    ref = np.asarray(jax.jit(jpp._pcl_virtual_intrinsics)(pos, K, wh))
    np.testing.assert_allclose(Kv, ref, rtol=GEOM, atol=0)


def test_inverse_and_unit_grid():
    """The adjugate inverse against LAPACK's (f64) and ``jnp.linalg.inv``;
    the sample lattice bit-equal to jitted ``jnp.linspace``."""
    _, K = _boxes_and_intrinsics(3, 16, 224)
    M = np.random.RandomState(3).randn(16, 3, 3).astype(np.float32)
    for A in (K, M):
        got = tpp.inverse_3x3(torch.from_numpy(A)).numpy()
        exact = np.linalg.inv(A.astype(np.float64))
        scale = np.abs(exact).max(axis=(1, 2), keepdims=True)
        assert np.max(np.abs(got - exact) / scale) < 1e-5
        np.testing.assert_allclose(got, np.asarray(jnp.linalg.inv(A)),
                                   rtol=1e-5, atol=1e-5 * np.abs(got).max())
    for n in (1, 7, 224):
        ref = np.asarray(jax.jit(lambda n=n: jnp.linspace(0.0, 1.0, n))())
        np.testing.assert_array_equal(tpp._unit_grid(n, "cpu").numpy(), ref)


def test_warp_homography_matches_jax():
    """Projective maps whose z changes sign and passes near 0 inside the
    output, zero fill outside the image."""
    rng = np.random.RandomState(4)
    B, res = 3, 24
    img = rng.rand(B, 40, 50, 3).astype(np.float32)
    P = np.tile(np.diag([40.0, 30.0, 1.0]).astype(np.float32), (B, 1, 1))
    P[1, 2] = [0.3, -0.8, 0.35]  # z crosses 0 across the output
    P[2, :2, 2] = [-20.0, 45.0]  # mostly outside the image
    P += rng.randn(B, 3, 3).astype(np.float32) * 0.05
    got = tpp.warp_homography(torch.from_numpy(img), torch.from_numpy(P),
                              res).numpy()
    ref = np.asarray(jax.jit(jpp.warp_homography, static_argnums=2)(
        img, P, res))
    assert got.shape == ref.shape == (B, res, res, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CROP)
    assert float((got[2] == 0).mean()) > 0.3  # the zero border
    # [u, v] -> [(n - 1) u + 0.5, (n - 1) v + 0.5]: projected pixel p
    # samples texel p - 0.5, so output pixel (i, j) is texel (i, j)
    n = 32
    P = np.asarray([[[n - 1, 0, 0.5], [0, n - 1, 0.5], [0, 0, 1]]],
                   np.float32)
    out = tpp.warp_homography(torch.from_numpy(img[:1]), torch.from_numpy(P),
                              n).numpy()
    np.testing.assert_allclose(out[0], img[0, :n, :n], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,res,out", [(0, 96, 32), (1, 224, 64)])
def test_pcl_crop_matches_jax(seed, res, out):
    B = 6
    img = np.random.RandomState(seed).rand(B, res, res, 3).astype(np.float32)
    box, K = _boxes_and_intrinsics(seed, B, res)
    crops, R = tpp.pcl_crop(torch.from_numpy(img), torch.from_numpy(box),
                            torch.from_numpy(K), out)
    ref_c, ref_R = jax.jit(jpp.pcl_crop, static_argnums=3)(img, box, K, out)
    assert crops.shape == (B, out, out, 3) and R.shape == (B, 3, 3)
    np.testing.assert_allclose(R.numpy(), np.asarray(ref_R), atol=GEOM)
    np.testing.assert_allclose(crops.numpy(), np.asarray(ref_c), atol=CROP)


def _jax_pcl_parts(img, box, K, out):
    """``jpp.pcl_crop`` written out to return its rotation R, virtual
    intrinsics Kv, homography P and crops (the same jitted arithmetic)."""
    with jax.default_matmul_precision("float32"):
        center = (box[:, :2] + box[:, 2:]) / 2.0
        wh = jnp.maximum(box[:, 2:] - box[:, :2], 1.0)
        size = jnp.maximum(wh[:, 0], wh[:, 1])
        pos = jnp.einsum("bij,bj->bi", jnp.linalg.inv(K),
                         jpp.to_homo2d(center))
        R = jpp._pcl_rotation_from_position(pos)
        Kv = jpp._pcl_virtual_intrinsics(pos, K, jnp.stack([size, size], -1))
        P = K @ R @ jnp.linalg.inv(Kv)
        return R, Kv, P, jpp.warp_homography(img, P, out)


def _jax_coords(P, out_res):
    """The texel coordinates of ``jpp.warp_homography``'s sampling."""
    t = jnp.linspace(0.0, 1.0, out_res)
    vs, us = jnp.meshgrid(t, t, indexing="ij")
    grid = jnp.stack([us, vs, jnp.ones_like(us)], -1).reshape(-1, 3)
    src = jnp.einsum("bij,pj->bpi", P, grid)
    den = jnp.maximum(jnp.abs(src[..., 2]), 1e-8)
    sign = jnp.sign(src[..., 2] + 1e-12)
    return (src[..., 0] / den * sign - 0.5, src[..., 1] / den * sign - 0.5)


@pytest.mark.parametrize("seed,res,out", [(0, 96, 32), (1, 224, 64)])
def test_warp_homography_on_the_jax_rotations_and_intrinsics(seed, res, out):
    """The JAX package's R and virtual K fed to the port: the port's
    homography is within 2 f32 ulps of XLA's, its sample coordinates
    within 4 ulps of jitted ``warp_homography``'s, and its crops within
    what 4 ulps of a coordinate move a bilinear sample (the largest step
    between neighbouring pixels, here up to 1). XLA's own op-by-op run lands
    as far from its jitted one: the crops' gap (and the 2.3e-4 of
    ``feat_vec`` a model reads from them) is the coordinates' rounding."""
    B = 6
    img = np.random.RandomState(seed).rand(B, res, res, 3).astype(np.float32)
    box, K = _boxes_and_intrinsics(seed, B, res)
    R, Kv, P, crops = (np.array(a) for a in jax.jit(
        _jax_pcl_parts, static_argnums=3)(img, box, K, out))
    np.testing.assert_array_equal(
        crops, np.asarray(jax.jit(jpp.pcl_crop, static_argnums=3)(
            img, box, K, out)[0]))
    Kt, Rt, Kvt = (torch.from_numpy(a) for a in (K, R, Kv))
    P_port = tpp._matmul_3x3(tpp._matmul_3x3(Kt, Rt), tpp.inverse_3x3(Kvt))
    ulp_P = np.spacing(np.abs(P).max(axis=(1, 2), keepdims=True))
    assert np.abs(P_port.numpy() - P).max() <= 2 * ulp_P.max()
    for a, b in zip(tpp.homography_coords(torch.from_numpy(P), out),
                    jax.jit(_jax_coords, static_argnums=1)(P, out)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b) / np.spacing(np.abs(b))) <= 4
    got = tpp.warp_homography(torch.from_numpy(img), P_port, out).numpy()
    step = max(np.abs(np.diff(img, axis=a)).max() for a in (1, 2))
    bound = 4 * np.spacing(np.float32(res)) * step
    assert np.abs(got - crops).max() <= bound, (np.abs(got - crops).max(),
                                                bound)
    with jax.disable_jit():
        op_by_op = np.asarray(_jax_pcl_parts(img, box, K, out)[3])
    assert np.abs(op_by_op - crops).max() > 0.5 * np.abs(got - crops).max()


def _compare(ref, got, cfg):
    """Every key of the three dicts: crops on their [0, 1] scale at CROP,
    the normalised patch at 2e-4, the rest at GEOM."""
    mean = np.asarray(cfg.img_norm_mean, np.float32)
    std = np.asarray(cfg.img_norm_std, np.float32)
    for r, g in zip(ref, got):
        assert set(r) == set(g), set(r) ^ set(g)
        for k in r:
            a = np.asarray(r[k])
            b = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert a.shape == b.shape, (k, a.shape, b.shape)
            if k in CROP_KEYS:
                a, b, atol = a * std + mean, b * std + mean, CROP
            else:
                atol = 2e-4 if k in IMAGE_KEYS else GEOM
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=atol,
                                       equal_nan=True, err_msg=k)


def test_eval_preprocessor_with_pcl_matches_jax():
    kw = dict(backbone="resnet18", pos_enc="pcl")
    cfg = default_config("hands_light", **kw)
    recs = records()
    ref = JaxPre(jax_config("hands_light", **kw), is_train=False)(
        jax_stack(recs), jax.random.PRNGKey(0))
    got = DevicePreprocessor(cfg, is_train=False, device="cpu")(
        stack_records(recs))
    assert {"r_rot", "l_rot", "r_center_angle"} <= set(got[0])
    _compare(ref, got, cfg)
    # the crops are not the axis-aligned ones of the default mode
    plain = DevicePreprocessor(cfg.replace(pos_enc=None), False,
                               device="cpu")(stack_records(recs))[0]
    assert float((plain["r_img"] - got[0]["r_img"]).abs().mean()) > 0.1


def test_train_preprocessor_with_pcl_matches_jax(monkeypatch):
    """Train mode with JAX's draws fed to the port (flip, rotation, scale,
    gains, box jitter), the JAX rotation through its gather oracle."""
    B = 6
    kw = dict(flip_prob=0.5, img_res=96, img_res_ds=64, pos_enc="pcl")
    cfg = default_config("hands_light", **kw)
    recs = train_records(B, False)
    monkeypatch.setattr(jpp, "rotate_patch", jpp.rotate_patch_gather)
    key = jax.random.PRNGKey(3)
    ref = JaxPre(jax_config("hands_light", **kw), is_train=True)(
        jax_stack(recs), key)
    k_aug, k_r, k_l = jax.random.split(key, 3)
    draws = {"augm": _augm_draws(k_aug, B),
             "jitter_r": np.asarray(jax.random.uniform(k_r, (B, 2))),
             "jitter_l": np.asarray(jax.random.uniform(k_l, (B, 2)))}
    got = DevicePreprocessor(cfg, is_train=True, device="cpu")(
        stack_records(recs), draws=draws)
    flips = np.asarray(ref[2]["is_flipped"])
    assert 0 < flips.sum() < B
    _compare(ref, got, cfg)
    # its own generator draws and runs too
    out = DevicePreprocessor(cfg, is_train=True, device="cpu")(
        stack_records(recs), generator=torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(out[0]["r_img"]).all())


def test_wildhands_on_the_ports_pcl_preprocessing_matches_jax():
    """The tiny WildHands model (ResNet-18, B = 2) with ``pos_enc="pcl"``,
    both packages' models on the port's own ``pcl`` preprocessing (crops,
    rotations, KPE angles): the rotations reach the global orientation."""
    kw = dict(backbone="resnet18", pos_enc="pcl", use_render_seg_loss=False)
    tin, _, tmeta = DevicePreprocessor(default_config("hands_light", **kw),
                                       False, device="cpu")(
        stack_records(records()))
    keys = ("img", "r_img", "l_img", "r_rot", "l_rot", "r_center_angle",
            "l_center_angle", "r_corner_angle", "l_corner_angle")
    meta = {"intrinsics": tmeta["intrinsics"].numpy(),
            "is_flipped": tmeta["is_flipped"].numpy()}
    ref, got, _, _ = run_pair(kw, {k: tin[k].numpy() for k in keys}, meta)
    worst, per_key = max_rel(ref, got)
    assert worst <= RTOL, per_key
