"""Port parity of the geometry that the WildHands forward added:
``core/rot.py`` (6D, Euler, flip), ``core/transforms.py``, ``core/thing.py``
and the decimation and sealing helpers of ``ops/mano.py``, each against its
JAX counterpart on inputs from a numpy seed. f32, tolerance 1e-6 absolute
unless stated (these are a few products of order-one numbers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.core import rot as jrot
from hands_tpu.core import transforms as jtf
from hands_tpu.ops import mano as jmano
from hands_tpu_torch.core import rot as trot
from hands_tpu_torch.core import thing
from hands_tpu_torch.core import transforms as ttf
from hands_tpu_torch.ops import mano as tmano


def _rots(n, seed):
    aa = (np.random.RandomState(seed).randn(n, 3) * 1.3).astype(np.float32)
    return np.array(jrot.axis_angle_to_matrix(jnp.asarray(aa)), np.float32)


def test_rot6d_round_trip_matches_jax():
    R = _rots(7, 0).reshape(7, 3, 3)
    d6 = trot.matrix_to_rot6d(torch.from_numpy(R))
    np.testing.assert_array_equal(
        d6.numpy(), np.asarray(jrot.matrix_to_rot6d(jnp.asarray(R))))
    noisy = d6.numpy() + np.random.RandomState(1).randn(7, 6).astype(
        np.float32) * 0.2
    ref = jrot.rot6d_to_matrix(jnp.asarray(noisy))
    got = trot.rot6d_to_matrix(torch.from_numpy(noisy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # row-major pytorch3d layout: not HaMeR's column layout
    assert not np.allclose(
        got.numpy(), trot.rot6d_to_matrix_hamer(torch.from_numpy(noisy)))
    np.testing.assert_allclose(
        trot.rot6d_to_matrix(d6).numpy(), R, atol=1e-6)


@pytest.mark.parametrize("convention", ["XYZ", "ZYX", "YXZ"])
def test_euler_angles_to_matrix_matches_jax(convention):
    e = (np.random.RandomState(2).randn(5, 3)).astype(np.float32)
    ref = jrot.euler_angles_to_matrix(jnp.asarray(e), convention)
    got = trot.euler_angles_to_matrix(torch.from_numpy(e), convention)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_flip_axis_angle_and_matrix_to_axis_angle_match_jax():
    aa = (np.random.RandomState(3).randn(4, 48) * 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        trot.flip_axis_angle(torch.from_numpy(aa)).numpy(),
        np.asarray(jrot.flip_axis_angle(jnp.asarray(aa))))
    R = _rots(9, 4)
    ref = jrot.matrix_to_axis_angle(jnp.asarray(R))
    got = trot.matrix_to_axis_angle(torch.from_numpy(R))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_transforms_match_jax():
    rng = np.random.RandomState(5)
    pts = rng.randn(3, 11, 3).astype(np.float32)
    pts[..., 2] += 4.0
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, :3] = _rots(3, 6)
    T[:, :3, 3] = rng.randn(3, 3)
    K = np.tile(np.asarray([[600, 0, 112], [0, 650, 110], [0, 0, 1]],
                           np.float32), (3, 1, 1))
    tp, jp = torch.from_numpy(pts), jnp.asarray(pts)
    np.testing.assert_array_equal(ttf.to_homo(tp).numpy(),
                                  np.asarray(jtf.to_homo(jp)))
    for got, ref in [
        (ttf.transform_points(torch.from_numpy(T), tp),
         jtf.transform_points(jnp.asarray(T), jp)),
        (ttf.rigid_tf(tp, torch.from_numpy(T[:, :3, :3]),
                      torch.from_numpy(T[:, :3, 3:])),
         jtf.rigid_tf(jp, jnp.asarray(T[:, :3, :3]),
                      jnp.asarray(T[:, :3, 3:]))),
        (ttf.to_xyz(ttf.to_homo(tp) * 2.0), jtf.to_xyz(jtf.to_homo(jp) * 2.0)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(  # pixels: order 100
        ttf.project2d(torch.from_numpy(K), tp).numpy(),
        np.asarray(jtf.project2d(jnp.asarray(K), jp)), atol=1e-4)


def test_thing_conversions():
    nest = {"a": [np.ones(2, np.float32), (np.zeros(1), "s")], "b": 3}
    t = thing.thing2torch(nest)
    assert isinstance(t["a"][0], torch.Tensor) and t["a"][1][1] == "s"
    back = thing.thing2np(thing.detach_thing(t))
    assert isinstance(back["a"][1][0], np.ndarray) and back["b"] == 3
    assert thing.thing2list(back)["a"][0] == [1.0, 1.0]
    moved = thing.thing_to_dev(nest, "cpu")
    assert moved["a"][0].device.type == "cpu" and type(moved["a"][1]) is tuple


@pytest.mark.parametrize("is_rhand", [True, False])
def test_decimate_and_seal_match_jax(is_rhand):
    verts = np.random.RandomState(7).randn(2, 778, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tmano.load_decimator(is_rhand).numpy(),
        np.asarray(jmano.load_decimator(is_rhand)))
    ref = jmano.decimate_verts(jnp.asarray(verts), is_rhand)
    got = tmano.decimate_verts(torch.from_numpy(verts), is_rhand)
    assert got.shape == (2, 195, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    faces = tmano.load_mano(is_rhand).faces
    jv, jf = jmano.seal_mano_mesh(jnp.asarray(verts),
                                  jmano.load_mano(is_rhand).faces, is_rhand)
    tv, tf_ = tmano.seal_mano_mesh(torch.from_numpy(verts), faces, is_rhand)
    assert tv.shape == (2, 779, 3) and tf_.shape == (1554, 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(tf_.numpy(), np.asarray(jf))
