"""Port parity: rotations, cameras, KPE encoders and XDict
(``hands_tpu_torch.core`` / ``models.kpe`` against ``hands_tpu``).

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: f32 geometry to 1e-5 absolute; outputs in pixels (projections,
intrinsics, magnitudes up to ~10^3) to 1e-6 relative plus 1e-4 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.core import camera as jcam
from hands_tpu.core import rot as jrot
from hands_tpu.models import kpe as jkpe
from hands_tpu_torch.core import camera as tcam
from hands_tpu_torch.core import rot as trot
from hands_tpu_torch.core.xdict import XDict
from hands_tpu_torch.models import kpe as tkpe

ATOL = 1e-5


def _both(fn_j, fn_t, *arrays):
    ref = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    got = fn_t(*[torch.from_numpy(a) for a in arrays]).numpy()
    return ref, got


def _axis_angles(rng, n):
    aa = rng.randn(n, 3).astype(np.float32)
    aa[:4] *= 1e-7          # near identity: the Taylor branches
    aa[4:8] *= 3.1 / np.linalg.norm(aa[4:8], axis=-1, keepdims=True)  # ~pi
    return aa


def test_axis_angle_to_matrix():
    aa = _axis_angles(np.random.RandomState(0), 64)
    ref, got = _both(jrot.axis_angle_to_matrix, trot.axis_angle_to_matrix, aa)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_matrix_to_axis_angle_all_quaternion_branches():
    rng = np.random.RandomState(1)
    aa = _axis_angles(rng, 64)
    R = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    # exact half turns about x, y and z select the three non-w branches
    half_turns = np.stack([np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                           np.diag([-1.0, -1, 1])])
    R = np.concatenate([R, half_turns]).astype(np.float32)
    ref, got = _both(jrot.matrix_to_axis_angle, trot.matrix_to_axis_angle, R)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_rot6d_to_matrix_hamer():
    d6 = np.random.RandomState(2).randn(4, 16, 6).astype(np.float32)
    ref, got = _both(jrot.rot6d_to_matrix_hamer, trot.rot6d_to_matrix_hamer,
                     d6)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("deg", [0.0, 25.0])
def test_rot_aa(deg):
    rng = np.random.RandomState(3)
    aa = _axis_angles(rng, 16)
    rot = np.full(16, deg, np.float32)
    ref, got = _both(jrot.rot_aa, trot.rot_aa, aa, rot)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_camera_helpers():
    rng = np.random.RandomState(4)
    B = 8
    wp = np.concatenate([rng.uniform(-0.5, 2, (B, 1)),
                         rng.randn(B, 2) * 0.1], -1).astype(np.float32)
    focal = rng.uniform(500, 1500, B).astype(np.float32)
    ref = np.asarray(jcam.weak_perspective_to_perspective(
        jnp.asarray(wp), jnp.asarray(focal), 224, min_s=0.1))
    got = tcam.weak_perspective_to_perspective(
        torch.from_numpy(wp), torch.from_numpy(focal), 224, min_s=0.1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=ATOL)

    K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = focal
    K[:, :2, 2] = rng.uniform(80, 140, (B, 2))
    pts = (rng.randn(B, 21, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    ref, got = _both(jcam.project2d, tcam.project2d, K, pts)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)  # pixels
    kp = (rng.rand(B, 21, 3) * 224).astype(np.float32)
    ref = np.asarray(jcam.normalize_kp2d(jnp.asarray(kp), 224))
    got = tcam.normalize_kp2d(torch.from_numpy(kp), 224).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)

    cx, cy = (rng.rand(2, B) * 300).astype(np.float32)
    scale = rng.uniform(0.5, 2, B).astype(np.float32)
    ref, got = _both(
        lambda *a: jcam.crop_adjusted_intrinsics(*a, 224),
        lambda *a: tcam.crop_adjusted_intrinsics(*a, 224), K, cx, cy, scale)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)  # pixels


@pytest.mark.parametrize("n_chan", [2, 8])
def test_sincos_pos_enc(n_chan):
    ang = np.random.RandomState(5).uniform(-1, 1, (4, n_chan)).astype(
        np.float32)
    ref, got = _both(lambda a: jkpe.sincos_pos_enc(a, 4),
                     lambda a: tkpe.sincos_pos_enc(a, 4), ang)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_xdict_collision_guard_and_namespacing():
    xd = XDict({"a": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(KeyError):
        xd["a"] = torch.ones(2)
    with pytest.raises(KeyError):
        xd.merge({"a": 1})
    out = xd.prefix("pred.").postfix(".r")
    assert list(out) == ["pred.a.r"]
    assert out.to_np()["pred.a.r"].dtype == np.float32  # bf16 widens
