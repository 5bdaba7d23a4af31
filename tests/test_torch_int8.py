"""Port parity of the W8A8 ViT blocks: the quantisation helpers, the plain
twins of the dynamic and the static int8 block (``hands_tpu_torch.ops.
vit_block_int8``) and ``Int8Dense`` against the JAX package.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against these twins; here the wrappers take the twins because the tensors
lie on the CPU. The Pallas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU.

The JAX side is compiled with ``xla_allow_excess_precision=False`` (see
test_torch_vit_block.py): the int8 blocks carry bf16 steps (q * scale, the
bf16 residual and probabilities of the static block) whose roundings XLA:CPU
otherwise skips, which moves a static block by a mean 8e-3.

Tolerances. The quantisation helpers: int8 tensors equal, f32 vectors to 1e-6
relative. The blocks: max |d| / max(|ref|, 1) <= 2^-6 and mean |d| <= 2e-4
with the tanh GELU, max <= 3e-2 and mean <= 1e-3 with the exact GELU (the
port calls erfc, the Pallas kernels a polynomial of abs error 1.5e-7, which
can flip a quantisation step). What is found is tighter: every block case
below agrees bit for bit, exact GELU included, and the tests assert that too.
Bit equality needs the scale ``amax / 127 + 1e-12`` computed as XLA compiles
it (one fused multiply-add of ``amax`` and ``1/127``): op by op, one folded
weight scale in ten moves by an ulp, an int8 weight flips, and a static block
moves by up to 4.5e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.models.backbones.vit import Block as JaxBlock
from hands_tpu.models.backbones.vit import Int8Dense as JaxInt8Dense
from hands_tpu.ops import quant as jquant
from hands_tpu.ops import vit_block_pallas as jvb
from hands_tpu_torch.models.backbones.vit import Int8Dense
from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops import vit_block as tvb
from hands_tpu_torch.ops import vit_block_int8 as t8
from test_torch_vit_block import _flax_block as _flax_block_bf16
from test_torch_vit_block import _port_block

NO_EXCESS = {"xla_allow_excess_precision": False}
SHAPES = [(2, 16, 128, 2), (2, 24, 160, 2)]  # the second: head dim 80


def _flax_block(B, N, C, heads, seed=0):
    x, _, params = _flax_block_bf16(B, N, C, heads, seed=seed)
    return x, params


def _act_scales(C, seed=5):
    rng = np.random.RandomState(seed)
    return {"qkv": rng.uniform(0.02, 0.05, C).astype(np.float32),
            "proj": rng.uniform(0.005, 0.02, C).astype(np.float32),
            "mlp1": rng.uniform(0.02, 0.05, C).astype(np.float32),
            "mlp2": rng.uniform(0.005, 0.03, 2 * C).astype(np.float32)}


def _assert_block_close(got, ref, fast_gelu):
    err = np.abs(got - ref)
    rel = np.max(err / np.maximum(np.abs(ref), 1.0))
    max_rel, max_mean = (2.0**-6, 2e-4) if fast_gelu else (3e-2, 1e-3)
    assert rel <= max_rel, rel
    assert np.mean(err) <= max_mean, err.mean()


def _f32_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ helpers
def test_quantize_weight_int8_matches_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(96, 160) * 0.1).astype(np.float32)  # JAX layout (in, out)
    q_ref, s_ref = jax.jit(jvb.quantize_weight_int8)(jnp.asarray(w))
    q, s = quant.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and q.shape == (160, 96)
    np.testing.assert_array_equal(q.numpy().T, np.asarray(q_ref))
    _f32_close(s.numpy(), np.asarray(s_ref))


def test_quant_rows_and_static_match_jax():
    rng = np.random.RandomState(1)
    a = (rng.randn(48, 160) * 2.0).astype(np.float32)
    q_ref, s_ref = jax.jit(jvb._quant_rows_f32)(jnp.asarray(a))
    q, s = quant.quant_rows_f32(torch.from_numpy(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    _f32_close(s.numpy(), np.asarray(s_ref))
    big = a * 60.0  # clips, and has exact halves after scaling
    big[0, :4] = [0.5, 1.5, 2.5, -0.5]  # half to even: 0, 2, 2, -0
    np.testing.assert_array_equal(
        quant.quant_static(torch.from_numpy(big)).numpy(),
        np.asarray(jvb._quant_static(jnp.asarray(big))))


@pytest.mark.parametrize("axes", [None, (1, 2, 3), (0, 1, 2)])
def test_quantize_int8_matches_jax(axes):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 4, 6).astype(np.float32)
    q_ref, s_ref = jax.jit(jquant.quantize_int8, static_argnames="axes")(
        jnp.asarray(x), axes=axes)
    q, s = quant.quantize_int8(torch.from_numpy(x), axes)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    _f32_close(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("B,N,C,heads", SHAPES)
def test_fold_static_scales_matches_jax(B, N, C, heads):
    _, params = _flax_block(B, N, C, heads, seed=3)
    sc = _act_scales(C)
    ref = jax.jit(jvb.fold_static_scales)(
        {k: jnp.asarray(v) for k, v in
         jvb.block_params_from_flax(params).items()},
        {k: jnp.asarray(v) for k, v in sc.items()})
    got = quant.fold_static_scales(
        tvb.block_params_from_flax(params, dtype=torch.float32),
        {k: torch.from_numpy(v) for k, v in sc.items()})
    assert set(got) == set(ref)
    for k, v in got.items():
        r = np.asarray(ref[k])
        if v.dtype == torch.int8:  # JAX keeps (in, out)
            np.testing.assert_array_equal(v.numpy().T, r, err_msg=k)
        else:
            assert v.dtype == torch.float32, k
            _f32_close(v.numpy(), r)


def test_int_matmul_is_exact_beyond_f32():
    """K = 5120 rows of +-127 overflow f32's 24 bits; int32 does not."""
    a = torch.full((2, 5120), 127, dtype=torch.int8)
    w = torch.full((3, 5120), -127, dtype=torch.int8)
    w[1] = 127
    got = quant.int_matmul(a, w)
    assert got.dtype == torch.int32
    assert got.tolist() == [[-82580480, 82580480, -82580480]] * 2


# ------------------------------------------------------------------- blocks
@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("B,N,C,heads", SHAPES)
def test_dynamic_twin_matches_pallas_interpret(B, N, C, heads, fast_gelu):
    """K5: ``vit_block_int8_plain`` against
    ``vit_block_fused_int8(interpret=True)``."""
    x, params = _flax_block(B, N, C, heads, seed=3)
    flat = {k: jnp.asarray(v) for k, v in
            jvb.block_params_from_flax(params).items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    kernel = jvb.vit_block_fused_int8.lower(
        xb, flat, num_heads=heads, fast_gelu=fast_gelu,
        interpret=True).compile(NO_EXCESS)
    ref = np.asarray(kernel(xb, flat), np.float32)
    op = quant.prepare_int8(
        tvb.block_params_from_flax(params, dtype=torch.float32))
    got = t8.vit_block_int8_plain(
        torch.from_numpy(x).to(torch.bfloat16), op, heads, fast_gelu)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, C)
    _assert_block_close(got.float().numpy(), ref, fast_gelu)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("fast_gelu", [True, False])
@pytest.mark.parametrize("B,N,C,heads", SHAPES)
def test_static_twin_matches_xla_twin_and_pallas_interpret(B, N, C, heads,
                                                           fast_gelu):
    """K6: ``vit_block_int8_static_plain`` against ``block_int8_static_xla``
    and against ``vit_block_fused_int8_static(interpret=True)``."""
    x, params = _flax_block(B, N, C, heads, seed=3)
    flat = {k: jnp.asarray(v) for k, v in
            jvb.block_params_from_flax(params).items()}
    sc = _act_scales(C)
    scj = {k: jnp.asarray(v) for k, v in sc.items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    op = quant.fold_static_scales(
        tvb.block_params_from_flax(params, dtype=torch.float32),
        {k: torch.from_numpy(v) for k, v in sc.items()})
    got = t8.vit_block_int8_static_plain(
        torch.from_numpy(x).to(torch.bfloat16), op, heads, fast_gelu)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, C)
    got = got.float().numpy()
    xla = jax.jit(jvb.block_int8_static_xla,
                  static_argnames=("num_heads", "fast_gelu"))
    refs = {
        "xla twin": xla.lower(xb, flat, scj, num_heads=heads,
                              fast_gelu=fast_gelu),
        "pallas": jvb.vit_block_fused_int8_static.lower(
            xb, flat, scj, num_heads=heads, fast_gelu=fast_gelu,
            interpret=True),
    }
    for name, lowered in refs.items():
        ref = np.asarray(lowered.compile(NO_EXCESS)(xb, flat, scj),
                         np.float32)
        _assert_block_close(got, ref, fast_gelu)
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_static_scales_are_used():
    """Garbage scales must move the static block (guards against the scales
    being ignored), and the wrappers take the twins on the CPU without
    counting a launch."""
    B, N, C, heads = 2, 16, 128, 2
    x, params = _flax_block(B, N, C, heads, seed=4)
    pt = tvb.block_params_from_flax(params, dtype=torch.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    sc = {k: torch.from_numpy(v) for k, v in _act_scales(C).items()}
    before = dict(t8.launches)
    good = t8.vit_block_fused_int8_static(
        xt, quant.fold_static_scales(pt, sc), num_heads=heads)
    bad = t8.vit_block_fused_int8_static(
        xt, quant.fold_static_scales(pt, {k: v * 37.0 for k, v in sc.items()}),
        num_heads=heads)
    dyn = t8.vit_block_fused_int8(xt, quant.prepare_int8(pt), num_heads=heads)
    assert t8.launches == before  # CPU runs are the twins, never counted
    torch.testing.assert_close(
        good, t8.vit_block_int8_static_plain(
            xt, quant.fold_static_scales(pt, sc), heads), rtol=0, atol=0)
    err_good = float((good.float() - dyn.float()).abs().mean())
    err_bad = float((bad.float() - dyn.float()).abs().mean())
    assert err_bad > 2 * err_good, (err_bad, err_good)


def test_static_int8_accuracy_vs_bf16_block():
    """Calibrated on the data it then sees, the static block is about as
    close to the bf16 block as the dynamic one (the JAX package's own bound:
    mean error below 1.3x the dynamic block's and below 5% of the mean
    magnitude)."""
    B, N, C, heads = 4, 16, 128, 2
    x, params = _flax_block(B, N, C, heads, seed=10)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    pt = tvb.block_params_from_flax(params, dtype=torch.float32)
    ref = tvb.vit_block_plain(xt, tvb.block_params_from_flax(params),
                              heads).float()
    cal = _port_block(params, C, heads, torch.bfloat16, quant_calibrate=True)
    with torch.no_grad():
        cal(xt)
    scales = {p: torch.clamp(getattr(cal, f"amax_{p}"), min=1e-6) / 127.0
              for p in ("qkv", "proj", "mlp1", "mlp2")}
    static = t8.vit_block_int8_static_plain(
        xt, quant.fold_static_scales(pt, scales), heads).float()
    dyn = t8.vit_block_int8_plain(xt, quant.prepare_int8(pt), heads).float()
    err_static = float((static - ref).abs().mean() / ref.abs().mean())
    err_dyn = float((dyn - ref).abs().mean() / ref.abs().mean())
    assert err_static < 1.3 * err_dyn, (err_static, err_dyn)
    assert err_static < 0.05


def test_wrappers_refuse_what_they_do_not_take():
    meta = torch.zeros(4, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        t8.ln_quant(meta, torch.ones(16), torch.zeros(16), True)
    with pytest.raises(ValueError):
        t8.quant_rows(meta)
    a = torch.zeros(4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    v = torch.zeros(8)
    with pytest.raises(ValueError):  # residual missing
        t8.gemm_i8(a, w, v, v, epilogue="residual")
    with pytest.raises(ValueError):  # no such epilogue
        t8.gemm_i8(a, w, v, v, epilogue="relu")
    with pytest.raises(ValueError):  # static GELU needs the next 1/s
        t8.gemm_i8(a, w, v, v, epilogue="gelu")
    with pytest.raises(ValueError):  # no f32 output in the static forms
        t8.gemm_i8(a, w, v, v, out_dtype=torch.float32)


# ------------------------------------------------------------------ modules
def test_int8_dense_matches_jax():
    """Per-tensor dynamic W8A8 dense, f32 output: 1e-6 relative to
    max(|ref|, 1)."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, 64).astype(np.float32)
    mod = JaxInt8Dense(96, dtype=jnp.float32)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"kernel": np.asarray(variables["params"]["kernel"]),
              "bias": rng.randn(96).astype(np.float32) * 0.1}
    ref = np.asarray(jax.jit(mod.apply)({"params": params}, jnp.asarray(x)))
    port = Int8Dense(64, 96, torch.float32)
    port.load_state_dict({
        "weight": torch.from_numpy(params["kernel"].T.copy()),
        "bias": torch.from_numpy(params["bias"])})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) <= 1e-6


def test_block_module_routes_int8_kernels_from_f32_masters():
    """``Block(quant_int8, fused_block)`` keeps f32 weights and gives the
    dynamic block exactly the operands quantised from them; with
    ``quant_static`` it folds its ``act_scale_*`` parameters, and folds
    again after they change."""
    B, N, C, heads = 2, 16, 128, 2
    x, params = _flax_block(B, N, C, heads, seed=8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    pt = tvb.block_params_from_flax(params, dtype=torch.float32)
    blk = _port_block(params, C, heads, torch.bfloat16, fused=True,
                      quant_int8=True)
    assert blk.attn.qkv.weight.dtype == torch.float32
    with torch.no_grad():
        got = blk(xt)
    want = t8.vit_block_int8_plain(xt, quant.prepare_int8(pt), heads)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    stat = _port_block(params, C, heads, torch.bfloat16, fused=True,
                       quant_int8=True, quant_static=True, fast_gelu=True)
    sc = {k: torch.from_numpy(v) for k, v in _act_scales(C).items()}
    with torch.no_grad():
        ones = stat(xt)
        for k, v in sc.items():
            getattr(stat, f"act_scale_{k}").copy_(v)
        stat.invalidate_prepared()
        got = stat(xt)
    want = t8.vit_block_int8_static_plain(
        xt, quant.fold_static_scales(pt, sc), heads, fast_gelu=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(ones, got)


def test_block_module_int8_dense_path_matches_flax_f32():
    """In f32 the kernel path is off and ``quant_int8`` means ``Int8Dense``,
    as in the Flax Block; the per-tensor quantisation steps are shared, so
    1e-5 relative to max(|ref|, 1) holds."""
    B, N, C, heads = 2, 16, 128, 2
    x, params = _flax_block(B, N, C, heads, seed=9)
    block = JaxBlock(num_heads=heads, mlp_ratio=2.0, dtype=jnp.float32,
                     quant_int8=True, fused_block=True)
    ref = np.asarray(jax.jit(block.apply)({"params": params}, jnp.asarray(x)))
    blk = _port_block(params, C, heads, torch.float32, fused=True,
                      quant_int8=True)
    assert not blk.fused and isinstance(blk.attn.qkv, Int8Dense)
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)) <= 1e-5
