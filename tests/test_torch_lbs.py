"""Port parity of the fused skinning (K1) and its gradient:
``hands_tpu_torch.ops.mano_lbs`` against ``hands_tpu.ops.mano_pallas.
lbs_apply`` (the Pallas kernel in interpret mode), the JAX einsum pair and
its ``jax.vjp``, on inputs from a numpy seed.

Tolerances: 1e-5 absolute, the bound of tests/test_pallas_lbs.py (f32 sums of
16 and 4 terms in another order); ``mano_forward`` through the wrapper against
the two inline products it replaced: 1e-6; the written-out backward against
autograd of the twin: 1e-6 (the same products, sums over 778 vertices in
another order), against ``jax.vjp``: 1e-5 of max(1, the largest entry) (d A
reaches 17 at unit upstream gradients, and XLA sums the 778 vertices in
another order: 1.3e-5 apart there); gradients of ``mano_forward`` against ``jax.grad``: 1e-5 of
the largest entry (sums over 778 vertices and the kinematic chain; 2e-6
observed). The CUDA
kernels cannot run here; on CPU tensors the wrapper runs the twins and counts
no launch.
"""

import numpy as np
import pytest
import torch

import jax
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


def _grad_out(B, seed):
    return (np.random.RandomState(seed).randn(B, 778, 3)).astype(np.float32)


def _twin_autograd(v_posed, w, A, g):
    """(d v_posed, d A, d w): autograd of the twin."""
    ins = [t.clone().requires_grad_(True) for t in (v_posed, A, w)]
    out = mano_lbs.lbs_apply_plain(ins[0], ins[2], ins[1])
    return torch.autograd.grad(out, ins, g)


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("is_rhand", [True, False])
def test_lbs_bwd_plain_matches_autograd_of_the_twin(B, is_rhand):
    v_posed, A = (torch.from_numpy(a) for a in _inputs(B, seed=20 + B))
    w = tmano.load_mano(is_rhand).lbs_weights
    g = torch.from_numpy(_grad_out(B, seed=30 + B))
    dv, dA = mano_lbs.lbs_apply_bwd_plain(v_posed, w, A, g)
    want_v, want_a, _ = _twin_autograd(v_posed, w, A, g)
    assert dv.shape == (B, 778, 3) and dA.shape == (B, 16, 4, 4)
    np.testing.assert_allclose(dv.numpy(), want_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(dA.numpy(), want_a.numpy(), atol=1e-6)
    assert not dA[:, :, 3].any()  # row 3 of A does not reach the output


@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("is_rhand", [True, False])
def test_lbs_bwd_plain_matches_jax_vjp(B, is_rhand):
    v_posed, A = _inputs(B, seed=40 + B)
    g = _grad_out(B, seed=50 + B)
    jw = jmano.load_mano(is_rhand).lbs_weights
    _, vjp = jax.vjp(lambda v, a: _jax_einsum(v, jw, a), jnp.asarray(v_posed),
                     jnp.asarray(A))
    want_v, want_a = vjp(jnp.asarray(g))
    dv, dA = mano_lbs.lbs_apply_bwd(
        torch.from_numpy(v_posed), tmano.load_mano(is_rhand).lbs_weights,
        torch.from_numpy(A), torch.from_numpy(g))
    for got, want in ((dv, want_v), (dA, want_a)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("B", [3, 8])
def test_lbs_wrapper_cpu_backward_is_the_written_out_one(B):
    """On CPU tensors the wrapper's gradient is :func:`lbs_apply_bwd_plain`
    to the bit, and no kernel is counted."""
    v_posed, A = (torch.from_numpy(a) for a in _inputs(B, seed=60 + B))
    w = tmano.load_mano(True).lbs_weights
    g = torch.from_numpy(_grad_out(B, seed=70 + B))
    v, a = v_posed.clone().requires_grad_(True), A.clone().requires_grad_(True)
    before = dict(mano_lbs.launches)
    got = torch.autograd.grad(mano_lbs.lbs_apply(v, w, a), (v, a), g)
    assert mano_lbs.launches == before
    for x, y in zip(got, mano_lbs.lbs_apply_bwd_plain(v_posed, w, A, g)):
        assert torch.equal(x, y)


def test_lbs_weights_gradient_takes_the_twin_route():
    """d lbs_weights (no path asks for it) is autograd of the twin."""
    v_posed, A = (torch.from_numpy(a) for a in _inputs(3, seed=80))
    w0 = tmano.load_mano(False).lbs_weights
    g = torch.from_numpy(_grad_out(3, seed=81))
    v, a, w = (t.clone().requires_grad_(True) for t in (v_posed, A, w0))
    got = torch.autograd.grad(mano_lbs.lbs_apply(v, w, a), (v, a, w), g)
    want_v, want_a, want_w = _twin_autograd(v_posed, w0, A, g)
    assert torch.equal(got[2], want_w)
    np.testing.assert_allclose(got[0].numpy(), want_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), want_a.numpy(), atol=1e-6)


@pytest.mark.parametrize("is_rhand", [True, False])
def test_mano_forward_gradients_match_jax(is_rhand):
    """d/d(betas, pose, orientation) of a fixed linear read-out of the
    vertices and joints, through the wrapper, against ``jax.grad`` of
    ``hands_tpu.ops.mano.mano_forward``."""
    rng = np.random.RandomState(12 + is_rhand)
    B = 3
    betas = (rng.randn(B, 10) * 0.8).astype(np.float32)
    pose = (rng.randn(B, 45) * 0.4).astype(np.float32)
    glob = (rng.randn(B, 3) * 1.2).astype(np.float32)
    gv = rng.randn(B, 778, 3).astype(np.float32)
    gj = rng.randn(B, 21, 3).astype(np.float32)

    jm = jmano.load_mano(is_rhand)

    def loss(b, p, o):
        out = jmano.mano_forward(jm, b, p, o)
        return jnp.sum(out.vertices * gv) + jnp.sum(out.joints * gj)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(glob))
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (betas, pose,
                                                             glob)]
    out = tmano.mano_forward(tmano.load_mano(is_rhand), *ins)
    got = torch.autograd.grad(
        (out.vertices * torch.from_numpy(gv)).sum()
        + (out.joints * torch.from_numpy(gj)).sum(), ins)
    for name, x, y in zip(("betas", "pose", "orientation"), got, want):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5 * np.abs(y).max(),
                                   err_msg=name)


def _refusal_cases():
    v_posed, A = (torch.from_numpy(a) for a in _inputs(2, seed=90))
    w = tmano.load_mano(True).lbs_weights
    return {
        "dtype v_posed": (v_posed.double(), w, A),
        "dtype A": (v_posed, w, A.half()),
        "dtype weights": (v_posed, w.double(), A),
        "shape v_posed": (v_posed[..., :2], w, A),
        "rank v_posed": (v_posed[0], w, A),
        "shape weights": (v_posed, w[:, :15], A),
        "vertices of weights": (v_posed, w[:700], A),
        "batch of A": (v_posed, w, A[:1]),
        "shape A": (v_posed, w, A[:, :, :3]),
        "device of A": (v_posed, w, A.to("meta")),
        "device of weights": (v_posed, w.to("meta"), A),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_lbs_wrappers_refuse(case):
    """Both wrappers raise on another dtype, shape or device; nothing is
    converted or falls back."""
    v_posed, w, A = _refusal_cases()[case]
    with pytest.raises(ValueError):
        mano_lbs.lbs_apply(v_posed, w, A)
    g = torch.zeros(v_posed.shape[:2] + (3,)) if v_posed.dim() == 3 else \
        torch.zeros(2, 778, 3)
    with pytest.raises(ValueError):
        mano_lbs.lbs_apply_bwd(v_posed, w, A, g)


@pytest.mark.parametrize("case", ["dtype", "shape", "device"])
def test_lbs_bwd_refuses_the_gradient(case):
    v_posed, A = (torch.from_numpy(a) for a in _inputs(2, seed=91))
    w = tmano.load_mano(True).lbs_weights
    g = {"dtype": torch.zeros(2, 778, 3, dtype=torch.float64),
         "shape": torch.zeros(2, 778, 4),
         "device": torch.zeros(2, 778, 3, device="meta")}[case]
    with pytest.raises(ValueError):
        mano_lbs.lbs_apply_bwd(v_posed, w, A, g)
