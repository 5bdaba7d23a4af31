"""The port's GEMMs on the CPU: the static dequantisation as one fused
multiply-add (``hands_tpu_torch.ops.quant.fma_f32`` / ``dequant_static``)
against an exact rational reference and against XLA, and the operand limits
of the TMA-fed GEMM kernels (``hands_tpu_torch.ops.cuda_build.
check_gemm_operands``), which every GEMM wrapper applies before a launch.

The kernels themselves (``csrc/gemm_sm90.cuh``) run only on the card, where
``chip_smoke.py`` holds them against these twins.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops.cuda_build import check_gemm_operands


def _f32(v) -> np.float32:
    return np.float32(v)


def _round_f32(exact: Fraction) -> np.float32:
    """``exact`` rounded to f32, to nearest, ties to even: the nearest of the
    f32 neighbours of its f64 approximation."""
    x = _f32(float(exact))
    cands = (np.nextafter(x, _f32(-np.inf)), x, np.nextafter(x, _f32(np.inf)))

    def key(c):
        odd = int(np.frombuffer(np.float32(c).tobytes(), np.uint32)[0]) & 1
        return abs(Fraction(float(c)) - exact), odd

    return min(cands, key=key)


def _exact_fma(a, b, c):
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def _fma(a, b, c):
    return quant.fma_f32(*(torch.from_numpy(np.asarray(v, np.float32))
                           for v in (a, b, c))).numpy()


def test_fma_f32_rounds_once_on_seeded_values():
    rng = np.random.RandomState(0)
    n = 3000
    a = (rng.randn(n) * 10.0 ** rng.randint(-3, 6, n)).astype(np.float32)
    b = (rng.randn(n) * 10.0 ** rng.randint(-6, 2, n)).astype(np.float32)
    c = (rng.randn(n) * 10.0 ** rng.randint(-3, 4, n)).astype(np.float32)
    want = _exact_fma(a, b, c)
    np.testing.assert_array_equal(_fma(a, b, c), want)
    # the values do tell one rounding from two
    twice = (a * b).astype(np.float32) + c
    assert np.mean(twice != want) > 0.05


def test_fma_f32_near_midpoints():
    """Products that put the exact sum just off an f32 midpoint, by less than
    an f64 ulp: rounding to f64 first lands on the midpoint, and the tie then
    goes the wrong way unless the f64 sum is rounded to odd."""
    lo, hi = _f32(1 - 2.0**-15), _f32(1 + 2.0**-15)  # lo * hi = 1 - 2^-30
    cases = []
    for k in (0, 20, -30, 60):
        half_ulp = 2.0 ** (k - 24)  # of c in [2^k, 2^(k+1))
        for c_mant in (1 + 2.0**-23, 1 + 3 * 2.0**-23, 1 + 2.0**-22):
            c = _f32(2.0**k * c_mant)
            b = _f32(lo * half_ulp)
            for sign in (1.0, -1.0):
                cases.append((_f32(sign * hi), _f32(sign * b), _f32(sign * c)))
    a, b, c = (np.array(v, np.float32) for v in zip(*cases))
    want = _exact_fma(a, b, c)
    np.testing.assert_array_equal(_fma(a, b, c), want)
    # the exact sum lies below the midpoint: a double rounding (f64, then
    # f32) breaks the tie toward an odd c's even neighbour above
    via_f64 = (a.astype(np.float64) * b + c).astype(np.float32)
    assert np.any(via_f64 != want)
    # and ties, overflow and the special values pass through
    a = np.array([1.0, 3e38, np.inf, np.nan, 0.0], np.float32)
    b = np.array([2.0**-24, 10.0, 1.0, 1.0, -0.0], np.float32)
    c = np.array([1.0, 0.0, -1.0, 1.0, 0.0], np.float32)
    got = _fma(a, b, c)
    assert got[0] == 1.0 and got[1] == np.inf and got[2] == np.inf
    assert np.isnan(got[3]) and got[4] == 0.0


@pytest.mark.parametrize("K", [16, 1296])
def test_dequant_static_is_xla_s_fused_multiply_add(K):
    """The JAX kernels' ``acc.astype(f32) * d + b`` as XLA compiles it (one
    fused multiply-add) equals ``quant.dequant_static`` bit for bit, on
    products that fill the int8 range."""
    rng = np.random.RandomState(K)
    a = rng.randint(-127, 128, (48, K)).astype(np.int8)
    w = rng.randint(-127, 128, (40, K)).astype(np.int8)
    d = (rng.rand(40) * 2e-4 + 5e-5).astype(np.float32)
    b = (rng.randn(40) * 30).astype(np.float32)
    acc = quant.int_matmul(torch.from_numpy(a), torch.from_numpy(w))
    got = quant.dequant_static(acc, torch.from_numpy(d),
                               torch.from_numpy(b)).numpy()
    fn = jax.jit(lambda acc, d, b: acc.astype(jnp.float32) * d + b)
    want = np.asarray(fn(jnp.asarray(acc.numpy()), d, b))
    np.testing.assert_array_equal(got, want)
    twice = (acc.float() * torch.from_numpy(d) + torch.from_numpy(b)).numpy()
    assert np.mean(twice != want) > 0.05  # one rounding, not two


def _aligned(n, dtype):
    t = torch.zeros(n + 64, dtype=dtype)
    off = (-t.data_ptr() % 16) // t.element_size()
    return t[off:off + n]


@pytest.mark.parametrize("dtype,k_unit", [(torch.bfloat16, 8),
                                          (torch.int8, 16)])
def test_gemm_operand_limits(dtype, k_unit):
    M, N, K = 6, 5, 4 * k_unit
    a, w = _aligned(M * K, dtype).view(M, K), _aligned(N * K, dtype).view(N, K)
    check_gemm_operands(a, w)
    # rows of a multiple of 16 bytes: K % 8 (bf16), K % 16 (int8)
    k_bad = K + k_unit // 2
    with pytest.raises(ValueError, match=f"K % {k_unit} == 0"):
        check_gemm_operands(_aligned(M * k_bad, dtype).view(M, k_bad),
                            _aligned(N * k_bad, dtype).view(N, k_bad))
    # 16-byte aligned base addresses, of either operand
    step = 8 // torch.empty((), dtype=dtype).element_size()
    shifted = _aligned(M * K + step, dtype)[step:].view(M, K)
    for args, name in (((shifted, w), "a"), ((a, shifted[:N]), "w")):
        with pytest.raises(ValueError, match=f"16-byte aligned.*{name} starts"):
            check_gemm_operands(*args)
