"""Port parity of the static-int8 block ablation (K8):
``hands_tpu_torch.ops.vit_block_ablation`` against ``run_variant`` of
``scripts/vith_int8_ablation.py`` with its Pallas kernel in interpret mode.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against the twins; here the wrappers take the twins because the tensors lie on
the CPU. The JAX side is compiled with ``xla_allow_excess_precision=False``
(see test_torch_vit_block.py): the block carries bf16 steps whose roundings
XLA:CPU otherwise skips.

Inputs. ``probe``: the script's own distribution (tokens ``randn * 0.5``,
weights of std 0.03, its fixed scales) at a small size. Its bare casts
truncate nearly everything to 0, so ``mm_only`` and ``no_quant`` are also held
on ``wide`` inputs: tokens, weights and biases scaled so that the values
reaching a cast spread over the int8 range and part of them exceed it.

Tolerances. On the probe inputs ``full``, ``attn_merged``, ``mm_only``,
``no_attn``, ``no_gelu`` and ``no_ln`` must be bit-equal to the Pallas kernel
(the tanh and softmax they share with the static block are held bit-equal by
that block's own test), and so must ``mm_only`` on the wide inputs: its
chain is the four products, the dequantisation ``acc * d + b`` and the bare
casts. XLA:CPU contracts that dequantisation into one fused multiply-add;
the twins (and the CUDA kernels) evaluate it as one too
(``quant.dequant_static``). Rounded twice, it put 2 of 6144 outputs of the
wide ``mm_only`` one bf16 ulp apart: an f32 ulp of difference, with biases of
tens and values of hundreds, now and then crossed a truncation boundary of
the next bare cast. For ``no_softmax``, ``attn_i8`` and ``no_quant`` an exp
or tanh that differs by an ulp between XLA and torch can move a value across a
rounding or truncation boundary, one int8 step that reaches the output through
a product; they get the bounds of the static block's test
(tests/test_torch_int8.py: max |d| / max(|ref|, 1) <= 2^-6, mean |d| <= 2e-4
of the mean magnitude, tanh GELU) and at most 1e-3 of the entries may differ.
The wide ``no_quant`` case gets the same bounds for the same reason.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import scripts.vith_int8_ablation as jabl  # noqa: E402
from hands_tpu_torch.cli import int8_ablation as cli  # noqa: E402
from hands_tpu_torch.ops import quant  # noqa: E402
from hands_tpu_torch.ops import vit_block_ablation as abl  # noqa: E402
from hands_tpu_torch.ops import vit_block_int8 as t8  # noqa: E402

NO_EXCESS = {"xla_allow_excess_precision": False}
B, N, C, HEADS, HIDDEN, TILE = 4, 12, 128, 2, 512, 2
EXACT = [("probe", m) for m in ("full", "attn_merged", "mm_only", "no_attn",
                                 "no_gelu", "no_ln")] + [("wide", "mm_only")]
MAX_REL, MAX_MEAN, MAX_SHARE = 2.0**-6, 2e-4, 1e-3


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the script's Pallas kernel in interpreter mode on the CPU."""
    orig = jax.experimental.pallas.pallas_call

    def interpreted(*args, **kwargs):  # the script passes interpret=False
        return orig(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(jabl.pl, "pallas_call", interpreted)
    yield


def _inputs(kind, seed=0, shape=(B, N, C, HIDDEN)):
    """(x, JAX-layout f32 params, scales) as numpy; ``shape`` is (batch,
    tokens, width, hidden)."""
    B, N, C, HIDDEN = shape
    rng = np.random.RandomState(seed)
    wide = kind == "wide"
    w_std, x_std, b_std = (1.0, 80.0, 60.0) if wide else (0.03, 0.5, 0.0)

    def mat(*shape):
        return (rng.randn(*shape) * w_std).astype(np.float32)

    def vec(n, base):
        if not wide:
            return np.full(n, base, np.float32)
        return (2.0 * base + rng.randn(n) * 0.2).astype(np.float32)

    params = {
        "ln1_scale": vec(C, 1.0), "ln1_bias": vec(C, 0.0),
        "wqkv": mat(C, 3 * C), "bqkv": (rng.randn(3 * C) * b_std).astype(np.float32),
        "wproj": mat(C, C), "bproj": (rng.randn(C) * b_std).astype(np.float32),
        "ln2_scale": vec(C, 1.0), "ln2_bias": vec(C, 0.0),
        "w1": mat(C, HIDDEN), "b1": (rng.randn(HIDDEN) * b_std).astype(np.float32),
        "w2": mat(HIDDEN, C), "b2": (rng.randn(C) * b_std).astype(np.float32),
    }
    x = (rng.randn(B, N, C) * x_std).astype(np.float32)
    scales = {"qkv": np.full(C, 4.0 / 127, np.float32),
              "proj": np.full(C, 2.0 / 127, np.float32),
              "mlp1": np.full(C, 4.0 / 127, np.float32),
              "mlp2": np.full(HIDDEN, 2.0 / 127, np.float32)}
    return x, params, scales


def _jax_variant(x, params, scales, mode, heads=HEADS):
    xb = jnp.asarray(x, jnp.bfloat16)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    fn = jax.jit(functools.partial(
        jabl.run_variant, scales={k: jnp.asarray(v) for k, v in scales.items()},
        num_heads=heads, mode=mode, tile=TILE))
    return np.asarray(fn.lower(xb, pj).compile(NO_EXCESS)(xb, pj), np.float32)


def _port_operands(params, scales):
    pt = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v)
          for k, v in params.items()}
    return quant.fold_static_scales(
        pt, {k: torch.from_numpy(v) for k, v in scales.items()})


CASES = [("probe", m) for m in abl.MODES] + [("wide", "mm_only"),
                                             ("wide", "no_quant")]


@pytest.mark.parametrize("kind,mode", CASES)
def test_twin_matches_run_variant_interpret(interpret_mode, kind, mode):
    x, params, scales = _inputs(kind)
    ref = _jax_variant(x, params, scales, mode)
    op = _port_operands(params, scales)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = (dict(abl.launches), dict(t8.launches))
    got = abl.vit_block_ablation(xt, op, num_heads=HEADS, mode=mode)
    assert (dict(abl.launches), dict(t8.launches)) == before  # CPU: twins
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, C)
    got = got.float().numpy()
    assert np.all(np.isfinite(got))
    if wide_case := kind == "wide":
        # the casts see the int8 range: not an all-zero comparison
        assert np.mean(np.abs(ref)) > 1.0
    if (kind, mode) in EXACT:
        np.testing.assert_array_equal(got, ref)
        return
    err = np.abs(got - ref)
    assert np.max(err / np.maximum(np.abs(ref), 1.0)) <= MAX_REL
    assert np.mean(err) <= MAX_MEAN * max(1.0, float(np.mean(np.abs(ref))))
    assert np.mean(err > 0) <= MAX_SHARE, np.mean(err > 0)


def test_attn_i8_twin_at_a_head_dim_off_the_mma_depth(interpret_mode):
    """``attn_i8`` at ViT-H's head dim 80 (C 160, 2 heads), which the int8
    tensor-core kernel pads to the MMA's depth of 32 (to 96), with 20 tokens,
    off the 16-row tiles and padded to 32 keys; the bounds of the parametrised
    test above."""
    shape = (2, 20, 160, 320)
    x, params, scales = _inputs("probe", seed=5, shape=shape)
    ref = _jax_variant(x, params, scales, "attn_i8")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = abl.vit_block_ablation(xt, _port_operands(params, scales),
                                 num_heads=HEADS, mode="attn_i8")
    assert got.shape == shape[:3]
    got = got.float().numpy()
    err = np.abs(got - ref)
    assert np.max(err / np.maximum(np.abs(ref), 1.0)) <= MAX_REL
    assert np.mean(err) <= MAX_MEAN * max(1.0, float(np.mean(np.abs(ref))))
    assert np.mean(err > 0) <= MAX_SHARE, np.mean(err > 0)


@pytest.mark.parametrize("n,d,ok", [
    (192, 80, True), (256, 128, True), (50, 20, True), (1, 4, True),
    (257, 80, False), (192, 82, False), (192, 132, False), (0, 80, False)])
def test_attention_i8_shape_limits(n, d, ok):
    """The int8 attention kernel's limits: N up to 256 keys (a row of logits
    in registers), a head dim that is a multiple of 4 up to 128; the rest is
    refused with a ValueError that names the limit."""
    if ok:
        abl.check_attention_i8_shape(n, d)
        return
    with pytest.raises(ValueError, match="256|128"):
        abl.check_attention_i8_shape(n, d)


def test_wide_inputs_reach_and_exceed_the_int8_range():
    """The `wide` inputs do what they are for: the values that meet the bare
    casts of ``mm_only`` and ``no_quant`` spread over the int8 range, some
    beyond it, few truncate to 0."""
    x, params, scales = _inputs("wide")
    op = _port_operands(params, scales)
    x2 = torch.from_numpy(x).to(torch.bfloat16).reshape(B * N, C)
    first = abl.cast_rows(x2)
    a = quant.int_matmul(first, op["wqkv_q"]).float() * op["dqkv"] + op["bqkv"]
    y = t8.layernorm_f32(x2.float(), op["ln1_s"], op["ln1_b"])
    for name, v in (("tokens", x2.float()), ("first product", a),
                    ("LayerNorm output", y)):
        v = v.numpy()
        assert np.mean(np.abs(v) >= 1.0) > 0.8, name
        assert 0.02 < np.mean(np.abs(v) > 127.0) < 0.6, name


def test_full_and_merged_equal_the_static_block():
    x, params, scales = _inputs("probe", seed=3)
    op = _port_operands(params, scales)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = t8.vit_block_int8_static_plain(xt, op, HEADS, fast_gelu=True)
    for mode in ("full", "attn_merged"):
        got = abl.vit_block_ablation_plain(xt, op, HEADS, mode, fast_gelu=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for mode in ("no_ln", "no_gelu", "no_softmax", "no_attn", "attn_i8"):
        got = abl.vit_block_ablation_plain(xt, op, HEADS, mode)
        assert not torch.equal(got, want), mode  # the knock-out is in effect


def test_cast_i8_is_xla_s_cast():
    v = np.asarray([0.5, 0.99, 1.5, -0.99, -1.5, 126.9, 127.5, 128.2, -127.9,
                    -128.9, -129.5, 255.0, 256.7, 300.7, -300.7, 1e10, -1e10,
                    np.nan, np.inf, -np.inf, 3e9, -3e9, 70000.3], np.float32)
    ref = np.asarray(jax.jit(lambda a: a.astype(jnp.int8))(jnp.asarray(v)))
    got = abl.cast_i8(torch.from_numpy(v.copy())).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.tolist()[:11] == [0, 0, 1, 0, -1, 126, 127, 127, -127, -128,
                                 -128]


def test_mode_table_and_wrappers():
    assert abl.MODES == jabl.MODES
    assert set(abl.MODE_LAUNCHES) == set(abl.MODES)
    assert abl.MODE_LAUNCHES["full"] == {
        "ln_quant_static": 2, "gemm_i8_static": 4, "qkv_attention_static": 1}
    for mode, table in abl.MODE_LAUNCHES.items():
        known = set(abl.launches) | set(t8.launches) | {"qkv_attention_static"}
        assert set(table) <= known, mode
    x, params, scales = _inputs("probe")
    op = _port_operands(params, scales)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with pytest.raises(ValueError):
        abl.vit_block_ablation(xt, op, num_heads=HEADS, mode="no_such")
    with pytest.raises(ValueError):  # no kernel or twin on this device
        abl.cast_rows(xt.to("meta"))
    with pytest.raises(ValueError):
        abl.ln_ablation(xt[0], op["ln1_s"], op["ln1_b"], False, False)
    a = torch.zeros(4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    v = torch.zeros(8)
    with pytest.raises(ValueError):
        abl.gemm_i8_ablation(a, w, v, v, "gelu_cast")  # inv_next missing
    with pytest.raises(ValueError):
        abl.gemm_i8_ablation(a, w, v, v, "cast", keep_cols=9)
    with pytest.raises(ValueError):
        abl.attention_ablation(xt, HEADS, v, "softmax")


def test_cli_prints_every_mode_and_the_attribution(capsys):
    """The entry point on the CPU at a small batch: nine ``ms/block`` lines,
    the attribution, and parameters drawn as the JAX script draws them."""
    lines = []
    probe = cli.make_probe(1, "cpu", c=C, hidden=HIDDEN, n_tok=N)
    res = cli.run_ablation(iters=1, device="cpu", probe=probe, heads=HEADS,
                           out=lines.append)
    assert list(res) == abl.MODES and all(v > 0 for v in res.values())
    text = "\n".join(lines)
    assert sum("ms/block" in ln for ln in lines) == 9
    assert "attribution (full - variant, ms):" in text
    assert sum(ln.startswith("  ") for ln in lines) == 8
    res = cli.main(["--batch", "1", "--iters", "1", "--device", "cpu",
                    "--modes", "no_attn"])  # full width, the cheapest mode
    assert list(res) == ["no_attn"]
    assert "no_attn" in capsys.readouterr().out
    # the same draws as scripts/vith_tile_autotune.py:make_params
    from scripts.vith_tile_autotune import make_params as jax_params
    ref = jax_params(np.random.RandomState(0), C, HIDDEN)
    got = cli.make_params(np.random.RandomState(0), C, HIDDEN)
    for k, v in got.items():
        r = np.asarray(ref[k])
        np.testing.assert_array_equal(v.numpy(), r.T if r.ndim == 2 else r)
