"""Port parity of K4, ``vit_block_fused_trainable``: the port's
``torch.autograd.Function`` against the JAX function with its Pallas forward
in interpret mode, on the CPU (where the port's forward runs the twin; the
backward is the same code on the card).

Same numpy inputs on both sides: x, a cotangent, and the twelve block
parameters as f32 masters. The JAX side is compiled as one program with
``xla_allow_excess_precision=False`` so that the recompute in its backward
keeps every bf16 rounding (see test_torch_vit_block.py).

Tolerances (bf16): the output as in test_torch_vit_block.py (3e-2 relative to
max(|ref|, 1), mean 1e-3). Each gradient leaf: max |a-b| <= 4e-2 of the leaf's
largest entry and mean |a-b| <= 4e-3 of it, the bound the JAX package's own
test holds the kernel's gradients to against the Flax block: the two
frameworks sum bf16 dot products in another order, a few bf16 ulps of a
leaf's scale. Observed maxima: 1.2e-2 of the largest entry (max), 1.9e-3
(mean); the outputs agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu_torch.models.backbones.vit import Block
from hands_tpu_torch.ops import vit_block as tvb

NO_EXCESS = {"xla_allow_excess_precision": False}
B, N, C, HEADS = 2, 16, 128, 2
HIDDEN = 2 * C


def _inputs(seed):
    """x, cotangent and flat f32 parameters in the JAX layout (kernels
    (in, out)), LayerNorm parameters off their 1/0 init."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = (rng.randn(B, N, C) * 0.5).astype(f)
    cot = (rng.randn(B, N, C) * 0.1).astype(f)

    def w(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(f)

    def v(n, base=0.0):
        return (base + rng.randn(n) * 0.05).astype(f)

    flat = {
        "ln1_scale": v(C, 1.0), "ln1_bias": v(C),
        "wqkv": w(C, 3 * C), "bqkv": v(3 * C),
        "wproj": w(C, C), "bproj": v(C),
        "ln2_scale": v(C, 1.0), "ln2_bias": v(C),
        "w1": w(C, HIDDEN), "b1": v(HIDDEN),
        "w2": w(HIDDEN, C), "b2": v(C),
    }
    return x, cot, flat


def _jax_value_and_grads(x, cot, flat, fast_gelu):
    def loss(x, p):
        out = jvb.vit_block_fused_trainable(x, p, HEADS, fast_gelu, True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    xb = jnp.asarray(x, jnp.bfloat16)
    p = {k: jnp.asarray(a) for k, a in flat.items()}
    fn = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    (gx, gp), out = fn.lower(xb, p).compile(NO_EXCESS)(xb, p)
    assert gx.dtype == jnp.bfloat16 and gp["wqkv"].dtype == jnp.float32
    return (np.asarray(out, np.float32), np.asarray(gx, np.float32),
            {k: np.asarray(a, np.float32) for k, a in gp.items()})


def _port_params(flat, requires_grad=True):
    """The JAX flat dict as the port's: kernels transposed to (out, in)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        a.T if a.ndim == 2 else a)).requires_grad_(requires_grad)
        for k, a in flat.items()}


def _port_value_and_grads(x, cot, flat, fast_gelu):
    p = _port_params(flat)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    before = dict(tvb.launches)
    out = tvb.vit_block_fused_trainable(xt, p, HEADS, fast_gelu)
    assert tvb.launches == before  # CPU: the twin, never counted
    (out.float() * torch.from_numpy(cot)).sum().backward()
    grads = {k: (t.grad.t() if t.ndim == 2 else t.grad).numpy()
             for k, t in p.items()}
    return out, xt.grad, grads, p


def _assert_leaf_close(got, ref, name):
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = np.abs(got - ref)
    assert err.max() <= 4e-2 * scale, (name, err.max(), scale)
    assert err.mean() <= 4e-3 * scale, (name, err.mean(), scale)


@pytest.mark.parametrize("fast_gelu", [False, True], ids=["erf", "tanh"])
def test_k4_output_and_gradients_match_pallas_interpret(fast_gelu):
    x, cot, flat = _inputs(9)
    ref_out, ref_gx, ref_gp = _jax_value_and_grads(x, cot, flat, fast_gelu)
    out, gx, gp, p = _port_value_and_grads(x, cot, flat, fast_gelu)

    assert out.dtype == torch.bfloat16 and out.shape == (B, N, C)
    err = np.abs(out.detach().float().numpy() - ref_out)
    assert np.max(err / np.maximum(np.abs(ref_out), 1.0)) <= 3e-2
    assert err.mean() <= 1e-3

    assert gx.dtype == torch.bfloat16  # the cotangent of a bf16 tensor
    _assert_leaf_close(gx.float().numpy(), ref_gx, "x")
    assert set(gp) == set(tvb.PARAM_ORDER) == set(ref_gp)
    for k in tvb.PARAM_ORDER:
        assert p[k].grad.dtype == torch.float32, k  # f32 masters, f32 grads
        assert gp[k].shape == ref_gp[k].shape, k
        assert np.abs(ref_gp[k]).max() > 0, k
        _assert_leaf_close(gp[k], ref_gp[k], k)


def test_k4_saves_only_input_and_parameters():
    """Block-granular rematerialisation: between forward and backward the
    Function holds x and the twelve parameters as given (the f32 masters, not
    their bf16 casts), and no activation of the block."""
    x, _, flat = _inputs(3)
    p = _port_params(flat)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = tvb.vit_block_fused_trainable(xt, p, HEADS)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 + len(tvb.PARAM_ORDER)
    assert saved[0].data_ptr() == xt.data_ptr()
    for t, k in zip(saved[1:], tvb.PARAM_ORDER):
        assert t.data_ptr() == p[k].data_ptr(), k
    # the plain twin, for contrast, keeps activations for autograd
    pb = tvb._cast_params(p)
    plain = tvb.vit_block_plain(xt, pb, HEADS)
    assert plain.grad_fn.name() != out.grad_fn.name()


def test_k4_gradients_equal_autograd_of_the_twin():
    """The backward is autograd of ``vit_block_plain`` on the bf16 cotangent:
    bit for bit on the CPU, where the forward is the twin too."""
    x, cot, flat = _inputs(5)
    _, gx, gp, _ = _port_value_and_grads(x, cot, flat, False)
    p = _port_params(flat)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = tvb.vit_block_plain(xt, tvb._cast_params(p), HEADS)
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert torch.equal(gx, xt.grad)
    for k, t in p.items():
        ref = (t.grad.t() if t.ndim == 2 else t.grad).numpy()
        np.testing.assert_array_equal(gp[k], ref, err_msg=k)


def test_k4_frozen_parameters_get_no_gradient():
    x, cot, flat = _inputs(6)
    p = _port_params(flat, requires_grad=False)
    p["w1"].requires_grad_(True)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = tvb.vit_block_fused_trainable(xt, p, HEADS)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert p["w1"].grad is not None and p["wqkv"].grad is None


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8_cfg"])
def test_block_routes_to_k4_as_the_jax_block(int8):
    """A bf16 ``fused_block`` Block runs K4 in eval and in train mode; with
    the int8 flags set, train mode still runs K4 (int8 is inference only),
    from the f32 parameters the int8 block keeps."""
    torch.manual_seed(0)
    blk = Block(C, HEADS, 2.0, torch.bfloat16, fused_block=True,
                quant_int8=int8, param_dtype=torch.float32)
    for prm in blk.parameters():
        torch.nn.init.normal_(prm, std=0.05)
    xt = (torch.randn(B, N, C) * 0.5).to(torch.bfloat16).requires_grad_(True)
    blk.train()
    out = blk(xt)
    assert out.grad_fn.name() == "_VitBlockTrainableBackward"
    ref = tvb.vit_block_plain(xt, tvb._cast_params(tvb.block_params(blk)),
                              HEADS)
    assert torch.equal(out, ref)
    out.float().sum().backward()
    assert blk.attn.qkv.weight.grad.dtype == torch.float32
    blk.eval()
    with torch.no_grad():
        served = blk(xt)
    assert served.dtype == torch.bfloat16
    assert torch.equal(served, ref) != int8  # int8 serves the W8A8 block
