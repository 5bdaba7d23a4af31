"""Port parity: the fused ViT block's plain twin (``hands_tpu_torch.ops.
vit_block``) against the JAX package's ``block_math`` compiled by XLA on the
CPU, and against the Pallas kernel in interpret mode.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against this twin there. Here the wrappers take the twin because the
tensors lie on the CPU.

The JAX side is compiled with ``xla_allow_excess_precision=False``: by
default XLA:CPU fuses chains of bf16 elementwise ops and skips their
intermediate roundings, which moves the compiled ``block_math`` away from
its own op-by-op result by a mean 3.6e-3 at (2, 24, 160). With the option
off, the compiled function keeps every bf16 rounding point it names.

Tolerance (bf16): max |a-b| / max(|a|, 1) <= 3e-2 and mean |a-b| <= 1e-3 —
the two frameworks sum the f32 products in another order, so a bf16
rounding (2^-8 relative) may land on the other side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.models.backbones.vit import Block as JaxBlock
from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu_torch.models.backbones.vit import Block
from hands_tpu_torch.ops import vit_block as tvb

NO_EXCESS = {"xla_allow_excess_precision": False}


def _flax_block(B, N, C, heads, dtype=jnp.bfloat16, seed=0):
    """Inputs and perturbed Flax Block params (LN scale/bias moved off
    their 1/0 init, which would hide a swapped or dropped operand)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, C) * 0.5).astype(np.float32)
    block = JaxBlock(num_heads=heads, mlp_ratio=2.0, dtype=dtype)
    variables = block.init(jax.random.PRNGKey(seed), jnp.asarray(x, dtype))
    noise = np.random.RandomState(seed + 1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + noise.randn(*p.shape).astype(np.float32)
        * 0.05, variables["params"])
    return x, block, params


def _jax_block_math(x, params, heads, fast_gelu=False):
    flat = {k: (jnp.asarray(v, jnp.float32) if k.startswith("ln")
                else jnp.asarray(v, jnp.bfloat16))
            for k, v in jvb.block_params_from_flax(params).items()}
    fn = jax.jit(lambda x, p: jvb.block_math(
        x, p["ln1_scale"], p["ln1_bias"], p["wqkv"], p["bqkv"], p["wproj"],
        p["bproj"], p["ln2_scale"], p["ln2_bias"], p["w1"], p["b1"], p["w2"],
        p["b2"], num_heads=heads, fast_gelu=fast_gelu))
    xb = jnp.asarray(x, jnp.bfloat16)
    return np.asarray(fn.lower(xb, flat).compile(NO_EXCESS)(xb, flat),
                      np.float32)


def _assert_bf16_close(got, ref):
    err = np.abs(got - ref)
    assert np.max(err / np.maximum(np.abs(ref), 1.0)) <= 3e-2, err.max()
    assert np.mean(err) <= 1e-3, err.mean()


# (2, 24, 160, 2): head dim 80, as in ViT-H
@pytest.mark.parametrize("B,N,C,heads", [(2, 16, 128, 2), (2, 24, 160, 2)])
def test_twin_matches_jax_block_math(B, N, C, heads):
    x, _, params = _flax_block(B, N, C, heads)
    ref = _jax_block_math(x, params, heads)
    p = tvb.block_params_from_flax(params)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tvb.vit_block_plain(xt, p, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, C)
    _assert_bf16_close(got.float().numpy(), ref)


def test_wrapper_takes_twin_on_cpu_without_launching():
    x, _, params = _flax_block(2, 24, 160, 2, seed=3)
    p = tvb.block_params_from_flax(params)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = dict(tvb.launches)
    got = tvb.vit_block_fused(xt, p, num_heads=2)
    assert tvb.launches == before  # CPU runs are the twin, never counted
    torch.testing.assert_close(got, tvb.vit_block_plain(xt, p, 2),
                               rtol=0, atol=0)


def _pallas_interpret(x, params, heads, fast_gelu):
    flat = {k: jnp.asarray(v) for k, v in
            jvb.block_params_from_flax(params).items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    kernel = jvb.vit_block_fused.lower(
        xb, flat, num_heads=heads, fast_gelu=fast_gelu,
        interpret=True).compile(NO_EXCESS)
    return np.asarray(kernel(xb, flat), np.float32)


@pytest.mark.parametrize("B,N,C,heads", [(2, 16, 128, 2)])
def test_twin_matches_pallas_kernel_interpret(B, N, C, heads):
    """The Pallas kernel itself, run the way the JAX tests reach it on the
    CPU (interpret mode). The twin keeps the kernel body's rounding points;
    besides holding the stated tolerance it agrees bit for bit here."""
    x, _, params = _flax_block(B, N, C, heads, seed=5)
    ref = _pallas_interpret(x, params, heads, fast_gelu=False)
    got = tvb.vit_block_plain(torch.from_numpy(x).to(torch.bfloat16),
                              tvb.block_params_from_flax(params), heads)
    _assert_bf16_close(got.float().numpy(), ref)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("B,N,C,heads", [(2, 16, 128, 2), (2, 24, 160, 2)])
def test_fast_gelu_twin_matches_pallas_kernel_interpret(B, N, C, heads):
    """``fast_gelu=True``: the tanh GELU of ``_gelu_mosaic(x, fast=True)``,
    ``jax.nn.gelu(approximate=True)`` on a bf16 array, with every step
    rounded to bf16 and the constants rounded first. Within tolerance of the
    Pallas kernel in interpret mode and of ``block_math``, and at (2, 16,
    128, 2) bit for bit, as the exact GELU is (at C = 160 the two frameworks
    sum the f32 products of the matmuls in another order and a few bf16
    roundings flip, with either GELU); the flag changes the result."""
    x, _, params = _flax_block(B, N, C, heads, seed=11)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    p = tvb.block_params_from_flax(params)
    got = tvb.vit_block_fused(xt, p, num_heads=heads, fast_gelu=True)
    ref = _pallas_interpret(x, params, heads, fast_gelu=True)
    _assert_bf16_close(got.float().numpy(), ref)
    if C == 128:
        np.testing.assert_array_equal(got.float().numpy(), ref)
    _assert_bf16_close(got.float().numpy(),
                       _jax_block_math(x, params, heads, fast_gelu=True))
    assert not torch.equal(got, tvb.vit_block_fused(xt, p, num_heads=heads))


def test_gelu_tanh_matches_jax_elementwise():
    """The tanh GELU alone on a dense grid of bf16 values, against
    ``jax.nn.gelu(approximate=True)`` compiled without excess precision:
    at most one bf16 ulp apart (XLA's tanh is its own polynomial), equal on
    more than 99.9% of the grid; in f32 to 1e-6."""
    grid = torch.linspace(-8, 8, 4001).to(torch.bfloat16)
    fn = jax.jit(lambda v: jax.nn.gelu(v, approximate=True))
    jx = jnp.asarray(grid.float().numpy(), jnp.bfloat16)
    ref = np.asarray(fn.lower(jx).compile(NO_EXCESS)(jx), np.float32)
    got = tvb.gelu_tanh(grid).float().numpy()
    ulp = np.maximum(np.abs(ref), 2.0**-126) * 2.0**-7
    assert np.all(np.abs(got - ref) <= ulp)
    assert np.mean(got == ref) > 0.999
    g32 = torch.linspace(-8, 8, 4001)
    ref32 = np.asarray(fn(jnp.asarray(g32.numpy())))
    np.testing.assert_allclose(tvb.gelu_tanh(g32).numpy(), ref32, atol=1e-6)


def _port_block(params, C, heads, dtype, fused=False, **flags):
    """A port ``Block`` filled from Flax Block params; the ``act_scale_*`` of
    a ``quant_static`` block keep their init."""
    blk = Block(C, heads, 2.0, dtype, fused_block=fused, **flags)
    sd = {}
    for (port, flax) in (("norm1", "norm1"), ("norm2", "norm2")):
        sd[f"{port}.scale"] = params[flax]["scale"]
        sd[f"{port}.bias"] = params[flax]["bias"]
    for port, (a, b) in (("attn.qkv", ("attn", "qkv")),
                         ("attn.proj", ("attn", "proj")),
                         ("mlp.fc1", ("mlp", "Dense_0")),
                         ("mlp.fc2", ("mlp", "Dense_1"))):
        sd[f"{port}.weight"] = params[a][b]["kernel"].T
        sd[f"{port}.bias"] = params[a][b]["bias"]
    blk.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()},
                        strict=not flags.get("quant_static", False))
    return blk


@pytest.mark.parametrize("fused", [False, True])
def test_port_block_module_bf16(fused):
    """The Block module's plain bf16 path and its kernel dispatch both track
    the Flax Block."""
    B, N, C, heads = 2, 24, 160, 2
    x, block, params = _flax_block(B, N, C, heads, seed=7)
    ref = np.asarray(block.apply({"params": params},
                                 jnp.asarray(x, jnp.bfloat16)), np.float32)
    blk = _port_block(params, C, heads, torch.bfloat16, fused)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).to(torch.bfloat16))
    _assert_bf16_close(got.float().numpy(), ref)


def test_port_block_module_f32():
    """In f32 the fused flag is ignored (kernel path is bf16 only), as in
    the JAX package; f32 tolerance 1e-5 relative to max(|ref|, 1)."""
    B, N, C, heads = 2, 16, 128, 2
    x, block, params = _flax_block(B, N, C, heads, dtype=jnp.float32, seed=9)
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    blk = _port_block(params, C, heads, torch.float32, fused=True)
    assert not blk.fused
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) < 1e-5


@pytest.mark.parametrize("C", [160, 768, 1280])
def test_layernorm_twin_matches_jax_layernorm_f32(C):
    """``layernorm_plain`` against the JAX package's ``_layernorm_f32`` on
    bf16 rows (13, off any rows-a-block count), rounded to bf16 at the end
    as K3 rounds it. Equal, or one bf16 ulp apart on few entries: the two
    frameworks sum a row's statistics in another order, so mu and var may
    differ in their last f32 bit and move an output that lies on a bf16
    rounding boundary."""
    rng = np.random.RandomState(C)
    x = (rng.randn(13, C) * 3.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fn = jax.jit(lambda a, s, b: jvb._layernorm_f32(
        a.astype(jnp.float32), s, b).astype(jnp.bfloat16))
    ref = np.asarray(fn.lower(xb, scale, bias).compile(NO_EXCESS)(
        xb, scale, bias), np.float32)
    got = tvb.layernorm(torch.from_numpy(np.asarray(xb, np.float32)).to(
        torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias)).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-126))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)
    assert np.mean(got != ref) <= 1e-2


@pytest.mark.parametrize("C,ok", [(8, True), (128, True), (160, True),
                                  (768, True), (1280, True), (2048, True),
                                  (4, False), (1284, False), (2056, False)])
def test_layernorm_width_limits(C, ok):
    """The LayerNorm kernel's widths: a multiple of 8 (16-byte loads) up to
    2048 (a row in one warp's registers); the rest raises a ValueError that
    names the limit."""
    if ok:
        tvb.check_layernorm_width(C)
        return
    with pytest.raises(ValueError, match="multiple of 8 up to 2048"):
        tvb.check_layernorm_width(C)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tvb.layernorm(x, torch.ones(8), torch.zeros(8))
    a = torch.zeros(4, 8, dtype=torch.bfloat16)
    w = torch.zeros(16, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tvb.gemm(a, w, torch.zeros(16, dtype=torch.bfloat16), "residual")
    with pytest.raises(ValueError):  # no such epilogue
        tvb.gemm(a, w, torch.zeros(16, dtype=torch.bfloat16), "relu")
