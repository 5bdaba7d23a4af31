"""K4's backward pieces on the CPU: ``layernorm_bwd_plain``,
``gelu_bwd_plain`` and ``attention_bwd_plain`` (the twins of the backward
kernels in ``hands_tpu_torch/csrc/vit_block_bwd.cu``) and the backward they
assemble, ``vit_block_backward``.

- Each twin is bit-equal to ``torch.autograd.grad`` of its forward twin: it
  is autograd written out, op by op, in the order the engine adds up the
  gradients that meet in one tensor.
- Each twin agrees with ``jax.vjp`` of the JAX package's forward on the same
  numpy inputs: ``_layernorm_f32`` (compiled with
  ``xla_allow_excess_precision=False``), ``jax.nn.gelu`` in both forms and
  the attention lines of ``block_math``. The two frameworks reduce in other
  orders and XLA rounds the bf16 GELU's derivative at other points, so
  the bounds are relative to the output's largest entry: a few bf16 ulps
  at the max, a fraction of one in the mean (the observed values sit in
  each test).
- The whole backward with the twins is bit-equal to autograd of
  ``vit_block_plain`` for both GELU forms and a ragged token count (the
  erf form at 16 tokens is ``test_torch_vit_block_trainable.py``'s).
- The kernel wrappers refuse what their kernels do not take and hand the C
  entries their arguments: on meta tensors, with the launch mocked.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu_torch.ops import vit_block as vb

NO_EXCESS = {"xla_allow_excess_precision": False}
B, C, HEADS = 2, 128, 2
BF = torch.bfloat16


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF)


def _ln_inputs(seed, rows):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(rows, C) * 1.5 + 0.3)
    dy = _bf16(rng.randn(rows, C) * 0.1)
    g_res = _bf16(rng.randn(rows, C) * 0.1)
    scale = torch.from_numpy((1.0 + 0.1 * rng.randn(C)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.randn(C)).astype(np.float32))
    return x, dy, g_res, scale, bias


def _qkv(seed, n_tok):
    rng = np.random.RandomState(seed)
    return (_bf16(rng.randn(B, n_tok, 3 * C)),
            _bf16(rng.randn(B, n_tok, C) * 0.1))


def _rel(got, ref):
    """(max |d|, mean |d|) over the reference's largest entry."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    return err.max() / scale, err.mean() / scale


def _equal(got, ref, name):
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    assert torch.equal(got, ref), (name, float((got.float()
                                                - ref.float()).abs().max()))


# ---------------------------------------------------- twin vs autograd
@pytest.mark.parametrize("rows", [2 * 16, 2 * 13])
def test_layernorm_bwd_twin_is_autograd(rows):
    x, dy, g_res, scale, bias = _ln_inputs(rows, rows)
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    y = vb.layernorm_plain(xs, ss, bs)
    # the residual's gradient meets the LayerNorm's in x, as in the block
    ref = torch.autograd.grad((y, xs.view(rows, C)), (xs, ss, bs),
                              (dy, g_res))
    got = vb.layernorm_bwd_plain(x, dy, scale, g_res)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, ref):
        _equal(a, b, name)


@pytest.mark.parametrize("fast", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", [(32, 256), (26, 256)])
def test_gelu_bwd_twin_is_autograd(fast, shape):
    rng = np.random.RandomState(shape[0] + fast)
    # values across the GELU's bend and its tails
    u = _bf16(rng.randn(*shape) * 2.5)
    dh = _bf16(rng.randn(*shape) * 0.1)
    us = u.clone().requires_grad_(True)
    h = vb.gelu(us, fast)
    (du_ref,) = torch.autograd.grad(h, us, dh)
    du, h_got = vb.gelu_bwd_plain(u, dh, fast)
    _equal(du, du_ref, "du")
    _equal(h_got, h.detach(), "h")


@pytest.mark.parametrize("n_tok", [16, 13])
def test_attention_bwd_twin_is_autograd(n_tok):
    qkv, do = _qkv(n_tok, n_tok)
    qs = qkv.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(vb.attention_plain(qs, HEADS), qs, do)
    _equal(vb.attention_bwd_plain(qkv, do, HEADS), ref, "dqkv")


def _block_inputs(seed, n_tok):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(B, n_tok, C) * 0.5)
    g = _bf16(rng.randn(B, n_tok, C) * 0.1)
    hidden = 2 * C
    shapes = {"ln1_scale": (C,), "ln1_bias": (C,), "wqkv": (3 * C, C),
              "bqkv": (3 * C,), "wproj": (C, C), "bproj": (C,),
              "ln2_scale": (C,), "ln2_bias": (C,), "w1": (hidden, C),
              "b1": (hidden,), "w2": (C, hidden), "b2": (C,)}
    p = {}
    for k in vb.PARAM_ORDER:
        a = rng.randn(*shapes[k]) * (shapes[k][-1] ** -0.5 if len(
            shapes[k]) == 2 else 0.05)
        if k.endswith("scale"):
            a = a + 1.0
        p[k] = torch.from_numpy(a.astype(np.float32))
    return x, g, p


@pytest.mark.parametrize("n_tok,fast", [(16, True), (13, False), (13, True)],
                         ids=["16-tanh", "13-erf", "13-tanh"])
def test_block_backward_with_twins_is_autograd_of_the_twin(n_tok, fast):
    x, g, p = _block_inputs(n_tok, n_tok)
    got = vb.vit_block_backward(x, p, g, HEADS, fast, f=vb.PLAIN)
    xs = x.clone().requires_grad_(True)
    ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = vb.vit_block_plain(xs, vb._cast_params(ps), HEADS, fast)
    ref = torch.autograd.grad(out, [xs] + [ps[k] for k in vb.PARAM_ORDER], g)
    for name, a, b in zip(("x",) + vb.PARAM_ORDER, got, ref):
        _equal(a, b, name)
    # the wrappers take the same route on CPU tensors
    again = vb.vit_block_backward(x, p, g, HEADS, fast)
    for name, a, b in zip(("x",) + vb.PARAM_ORDER, again, got):
        _equal(a, b, name)


# ---------------------------------------------------- twin vs JAX
@pytest.mark.parametrize("rows", [2 * 16, 2 * 13])
def test_layernorm_bwd_twin_matches_jax(rows):
    x, dy, _, scale, bias = _ln_inputs(rows + 1, rows)

    def f(xb, s, b):
        return jvb._layernorm_f32(xb.astype(jnp.float32), s, b).astype(
            jnp.bfloat16)

    def vjp(xb, s, b, ct):
        return jax.vjp(f, xb, s, b)[1](ct)

    args = (jnp.asarray(x.float().numpy(), jnp.bfloat16),
            jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
            jnp.asarray(dy.float().numpy(), jnp.bfloat16))
    ref = jax.jit(vjp).lower(*args).compile(NO_EXCESS)(*args)
    zero = torch.zeros_like(x)
    got = vb.layernorm_bwd_plain(x, dy, scale, zero)
    # dx is bf16 (one ulp 2^-8 relative); dscale and dbias f32 column sums
    # of R terms in another order. Observed: dx and dbias bit-equal, dscale
    # 1.6e-7 max, 3.6e-8 mean
    for name, a, b, lim in zip(("dx", "dscale", "dbias"), got, ref,
                               (1.6e-2, 1e-5, 1e-5)):
        mx, mean = _rel(a.float().numpy(), b)
        assert mx <= lim and mean <= lim / 10, (name, mx, mean)


@pytest.mark.parametrize("fast", [False, True], ids=["erf", "tanh"])
def test_gelu_bwd_twin_matches_jax(fast):
    rng = np.random.RandomState(7 + fast)
    u = _bf16(rng.randn(64, 256) * 2.5)
    dh = _bf16(rng.randn(64, 256) * 0.1)
    ub = jnp.asarray(u.float().numpy(), jnp.bfloat16)
    ct = jnp.asarray(dh.float().numpy(), jnp.bfloat16)

    def vjp(a, c):
        h, back = jax.vjp(lambda t: jax.nn.gelu(t, approximate=fast), a)
        return h, back(c)[0]

    h_ref, du_ref = jax.jit(vjp).lower(ub, ct).compile(NO_EXCESS)(ub, ct)
    du, h = vb.gelu_bwd_plain(u, dh, fast)
    # bf16 chains of 6-12 roundings: XLA's derivative rounds at other
    # points (x**3, the erfc derivative in f32). Observed: h bit-equal; du
    # 5.1e-3 max, 8.3e-5 mean (erf), 1.4e-2, 5.8e-4 (tanh)
    for name, a, b in (("h", h, h_ref), ("du", du, du_ref)):
        mx, mean = _rel(a.float().numpy(), b)
        assert mx <= 3e-2 and mean <= 2e-3, (name, mx, mean)


def _jax_attention(qkv, num_heads):
    """``block_math``'s attention lines on a (B, N, 3C) bf16 qkv."""
    TB, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    qkv = qkv.reshape(TB, N, 3, num_heads, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = D**-0.5
    s = jnp.einsum("bnhd,bmhd->bhnm", q * scale, k).astype(jnp.float32)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhnm,bmhd->bnhd", p, v)
    return o.reshape(TB, N, C).astype(jnp.bfloat16)


@pytest.mark.parametrize("n_tok", [16, 13])
def test_attention_bwd_twin_matches_jax(n_tok):
    qkv, do = _qkv(n_tok + 3, n_tok)
    a = jnp.asarray(qkv.float().numpy(), jnp.bfloat16)
    ct = jnp.asarray(do.float().numpy(), jnp.bfloat16)

    def vjp(t, c):
        return jax.vjp(lambda u: _jax_attention(u, HEADS), t)[1](c)[0]

    ref = jax.jit(vjp).lower(a, ct).compile(NO_EXCESS)(a, ct)
    got = vb.attention_bwd_plain(qkv, do, HEADS)
    # bf16 dq, dk, dv from f32 sums that may run in another order.
    # Observed: bit-equal
    for s, name in enumerate(("dq", "dk", "dv")):
        part = slice(s * C, (s + 1) * C)
        mx, mean = _rel(got[..., part].float().numpy(),
                        np.asarray(ref, np.float32)[..., part])
        assert mx <= 3e-2 and mean <= 2e-3, (name, mx, mean)


# ---------------------------------------------------- kernel wrappers
def _kernel_path():
    return (mock.patch.object(vb, "_on_cpu", lambda t: False),
            mock.patch.object(vb.BWD_LIBRARY, "launch"))


def _meta(*shape, dtype=BF):
    return torch.zeros(shape, dtype=dtype, device="meta")


def test_attention_bwd_kernel_path():
    """Refused: a head dim off 16, more than 256 tokens, a wrong gradient
    shape, f32; taken: the C entry gets B, N, H, D and bf16(D^-0.5)."""
    on_cpu, launch_patch = _kernel_path()
    before = dict(vb.bwd_launches)
    with on_cpu, launch_patch as launch:
        for qkv, do, heads in ((_meta(2, 13, 120), _meta(2, 13, 40), 2),
                               (_meta(1, 257, 384), _meta(1, 257, 128), 2),
                               (_meta(2, 13, 384), _meta(2, 12, 128), 2),
                               (_meta(2, 13, 384, dtype=torch.float32),
                                _meta(2, 13, 128), 2)):
            with pytest.raises(ValueError):
                vb.attention_bwd(qkv, do, heads)
        assert launch.call_count == 0
        dqkv = vb.attention_bwd(_meta(2, 13, 3 * 1280), _meta(2, 13, 1280),
                                16)
        args = launch.call_args.args
        assert args[0] == "vbb_attention_bwd"
        assert args[-5:] == (2, 13, 16, 80, vb.bf16_const(80**-0.5))
    assert dqkv.shape == (2, 13, 3 * 1280) and dqkv.dtype == BF
    assert vb.bwd_launches["attention_bwd"] == before["attention_bwd"] + 1
    vb.bwd_launches.update(before)


def test_layernorm_bwd_kernel_path():
    """Refused: a width off 8 or past 2048, an f32 gradient, a wrong scale;
    taken: two launches, the rows with blocks = min(ceil(R / 8), two an
    SM) and the column sums of those blocks' partials."""
    on_cpu, launch_patch = _kernel_path()
    before = dict(vb.bwd_launches)
    props = mock.Mock(multi_processor_count=2)  # blocks: 2 an SM
    with on_cpu, launch_patch as launch, mock.patch.object(
            torch.cuda, "get_device_properties", lambda dev: props):
        for c in (1284, 2056):
            with pytest.raises(ValueError):
                vb.layernorm_bwd(_meta(5, c), _meta(5, c),
                                 _meta(c, dtype=torch.float32), _meta(5, c))
        with pytest.raises(ValueError):
            vb.layernorm_bwd(_meta(5, 160), _meta(5, 160,
                                                  dtype=torch.float32),
                             _meta(160, dtype=torch.float32), _meta(5, 160))
        with pytest.raises(ValueError):
            vb.layernorm_bwd(_meta(5, 160), _meta(5, 160), _meta(160),
                             _meta(5, 160))
        assert launch.call_count == 0
        for rows, blocks in ((13, 2), (100, 4)):
            dx, ds, db = vb.layernorm_bwd(
                _meta(rows, 160), _meta(rows, 160),
                _meta(160, dtype=torch.float32), _meta(rows, 160))
            (rows_call, sums_call) = launch.call_args_list[-2:]
            assert rows_call.args[0] == "vbb_layernorm_bwd"
            assert rows_call.args[-4:] == (rows, 160, blocks, 1e-6)
            assert sums_call.args[0] == "vbb_column_sums"
            assert sums_call.args[-2:] == (blocks, 320)
            assert dx.shape == (rows, 160) and dx.dtype == BF
            assert ds.shape == db.shape == (160,)
            assert ds.dtype == db.dtype == torch.float32
    assert vb.bwd_launches["layernorm_bwd"] == before["layernorm_bwd"] + 2
    assert (vb.bwd_launches["layernorm_bwd_sums"]
            == before["layernorm_bwd_sums"] + 2)
    vb.bwd_launches.update(before)


@pytest.mark.parametrize("fast", [False, True])
def test_gelu_bwd_kernel_path(fast):
    """Refused: f32 or a gradient of another shape; taken: the C entry gets
    the value count and the form."""
    on_cpu, launch_patch = _kernel_path()
    before = dict(vb.bwd_launches)
    with on_cpu, launch_patch as launch:
        with pytest.raises(ValueError):
            vb.gelu_bwd(_meta(13, 5120, dtype=torch.float32),
                        _meta(13, 5120), fast)
        with pytest.raises(ValueError):
            vb.gelu_bwd(_meta(13, 5120), _meta(13, 5119), fast)
        assert launch.call_count == 0
        du, h = vb.gelu_bwd(_meta(13, 5120), _meta(13, 5120), fast)
        assert launch.call_args.args[0] == "vbb_gelu_bwd"
        assert launch.call_args.args[-2:] == (13 * 5120, int(fast))
    assert du.shape == h.shape == (13, 5120) and du.dtype == h.dtype == BF
    assert vb.bwd_launches["gelu_bwd"] == before["gelu_bwd"] + 1
    vb.bwd_launches.update(before)
