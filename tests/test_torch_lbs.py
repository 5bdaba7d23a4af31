"""Port parity of the fused skinning (K1): ``hands_tpu_torch.ops.mano_lbs``
against ``hands_tpu.ops.mano_pallas.lbs_apply`` (the Pallas kernel in
interpret mode) and the JAX einsum pair, on inputs from a numpy seed.

Tolerances: 1e-5 absolute, the bound of tests/test_pallas_lbs.py (f32 sums of
16 and 4 terms in another order); ``mano_forward`` through the wrapper against
the two inline products it replaced: 1e-6. The CUDA kernel cannot run here;
on a CPU tensor the wrapper runs the twin and counts no launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hands_tpu.core import rot as jrot
from hands_tpu.ops import mano as jmano
from hands_tpu.ops.mano_pallas import lbs_apply as jax_lbs_apply
from hands_tpu_torch.ops import mano as tmano
from hands_tpu_torch.ops import mano_lbs


def _inputs(B, seed):
    rng = np.random.RandomState(seed)
    v_posed = (rng.randn(B, 778, 3) * 0.1).astype(np.float32)
    R = np.asarray(jrot.axis_angle_to_matrix(
        jnp.asarray(rng.randn(B, 16, 3) * 0.3, jnp.float32)))
    A = np.zeros((B, 16, 4, 4), np.float32)
    A[:, :, :3, :3] = R
    A[:, :, :3, 3] = rng.randn(B, 16, 3) * 0.05
    A[:, :, 3, 3] = 1.0
    return v_posed, A


def _jax_einsum(v_posed, w, A):
    T = jnp.einsum("vj,bjrc->bvrc", w, A)
    vh = jnp.concatenate(
        [v_posed, jnp.ones(v_posed.shape[:2] + (1,), v_posed.dtype)], -1)
    return jnp.einsum("bvrc,bvc->bvr", T, vh)[..., :3]


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("is_rhand", [True, False])
def test_lbs_twin_matches_jax_kernel_and_einsum(B, is_rhand):
    v_posed, A = _inputs(B, seed=B)
    jw = jmano.load_mano(is_rhand).lbs_weights
    tw = tmano.load_mano(is_rhand).lbs_weights
    before = dict(mano_lbs.launches)
    got = mano_lbs.lbs_apply(torch.from_numpy(v_posed), tw,
                             torch.from_numpy(A)).numpy()
    assert mano_lbs.launches == before  # CPU: the twin ran, no kernel
    assert got.shape == (B, 778, 3)
    kern = jax_lbs_apply(jnp.asarray(v_posed), jw, jnp.asarray(A),
                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=1e-5)
    ref = _jax_einsum(jnp.asarray(v_posed), jw, jnp.asarray(A))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_lbs_gradient_matches_plain():
    """The wrapper stays differentiable (on the CPU through the twin)."""
    v_posed, A = _inputs(2, seed=5)
    w = tmano.load_mano(True).lbs_weights
    v = torch.from_numpy(v_posed).requires_grad_(True)
    a = torch.from_numpy(A).requires_grad_(True)
    g = torch.from_numpy(
        np.random.RandomState(6).randn(2, 778, 3).astype(np.float32))
    (mano_lbs.lbs_apply(v, w, a) * g).sum().backward()
    # d out / d v_posed = T[:, :, :3, :3]^T g
    T = torch.einsum("vj,bjrc->bvrc", w, a.detach())
    want = torch.einsum("bvrc,bvr->bvc", T[..., :3, :3], g)
    np.testing.assert_allclose(v.grad.numpy(), want.numpy(), atol=1e-5)
    assert a.grad.shape == A.shape and bool(torch.isfinite(a.grad).all())


def test_lbs_wrapper_refuses_other_devices():
    v_posed, A = _inputs(1, seed=1)
    w = tmano.load_mano(True).lbs_weights
    with pytest.raises(ValueError, match="no kernel or twin"):
        mano_lbs.lbs_apply(torch.from_numpy(v_posed).to("meta"), w,
                           torch.from_numpy(A))


@pytest.mark.parametrize("is_rhand", [True, False])
def test_mano_forward_unchanged_by_the_wrapper(is_rhand):
    """``mano_forward`` through ``lbs_apply`` against the two inline
    products it replaced, 1e-6, and against the JAX ``mano_forward``, 1e-5."""
    rng = np.random.RandomState(11)
    B = 5
    betas = (rng.randn(B, 10) * 0.8).astype(np.float32)
    pose = (rng.randn(B, 45) * 0.4).astype(np.float32)
    glob = (rng.randn(B, 3) * 1.2).astype(np.float32)
    model = tmano.load_mano(is_rhand)
    got = tmano.mano_forward(model, torch.from_numpy(betas),
                             torch.from_numpy(pose), torch.from_numpy(glob))

    # the former inline form, from the same intermediates
    tb, tp, tg = (torch.from_numpy(a) for a in (betas, pose, glob))
    v_shaped = model.v_template + torch.einsum("vcs,bs->bvc",
                                               model.shapedirs, tb)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    from hands_tpu_torch.core import rot as trot
    rot_mats = trot.axis_angle_to_matrix(
        torch.cat([tg, tp + model.hand_mean[None]], -1).reshape(B, 16, 3))
    feat = (rot_mats[:, 1:] - torch.eye(3)).reshape(B, 135)
    v_posed = v_shaped + (feat @ model.posedirs).reshape(B, 778, 3)
    _, A = tmano._rigid_transform_chain(rot_mats, j_rest)
    T = torch.einsum("vj,bjrc->bvrc", model.lbs_weights, A)
    v_homo = torch.cat([v_posed, torch.ones(B, 778, 1)], -1)
    inline = torch.einsum("bvrc,bvc->bvr", T, v_homo)[..., :3]
    np.testing.assert_allclose(got.vertices.numpy(), inline.numpy(),
                               atol=1e-6)

    ref = jmano.mano_forward(jmano.load_mano(is_rhand), jnp.asarray(betas),
                             jnp.asarray(pose), jnp.asarray(glob))
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(ref.vertices), atol=1e-5)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                               atol=1e-5)
