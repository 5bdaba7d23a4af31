"""The f32 route of ``mha_fused`` (``csrc/attention_f32.cuh``) on the CPU.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against ``mha_plain``. Here a numpy emulation of its 3xTF32 arithmetic shows
that the split holds the card's limit: each f32 operand x becomes big =
rna_tf32(x) and small = rna_tf32(x - big), rounded by bit arithmetic (the
kernel adds half of the dropped field and the tensor cores drop it, which on
the H100 is bit-equal to dropping it first); each 8-wide product step of
``mma.sync m16n8k8`` issues small.big, big.small, big.big into the
accumulator in that order (an MMA modelled as its exact sum added to the
accumulator and rounded to f32 once); the softmax runs as the twin's.
Against ``mha_plain`` and the JAX ``mha_fused`` in interpret mode it stays
within the card's limit, max |d| / max(|ref|, 1) <= 2e-5 and mean |d| <=
2e-6, at the shapes of ``chip_smoke.ATTN_SWEEP`` (two heads), at HaMeR's
(2, 192, 4, 80) and at a head dim padded to 8; one TF32 product alone
misses it.

Then the wrapper's f32 routes on meta tensors: every shape a route takes
reaches one launch in that route's mode, counted under its name; every
shape past both routes' shared memory raises before any launch.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hands_tpu.ops.attention_pallas as jap
from hands_tpu_torch.ops import attention as tat

REL, MEAN = 2e-5, 2e-6  # chip_smoke's f32 limit against mha_plain

# (B, N, H, D): chip_smoke.ATTN_SWEEP's shapes with two heads, HaMeR's shape,
# and a head dim that is no multiple of 8 (zero-padded to 24)
SHAPES = [(1, 50, 2, 64), (1, 50, 2, 80), (1, 145, 2, 64), (1, 145, 2, 80),
          (1, 256, 2, 64), (1, 145, 2, 128), (2, 24, 2, 16), (2, 192, 4, 80),
          (1, 40, 2, 20)]


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest tf32 value (10 stored mantissa bits), ties away
    from zero: ``(bits + 0x1000) & 0xffffe000``, the value of the kernel's
    ``tf32_rna`` operand."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)  # x - big is exact in f32


def mma_steps(acc, a, b, terms):
    """``acc`` += a . b over 8-wide steps of the contracted axis, each step
    as ``terms`` MMAs on (big, small) parts: 3 is the kernel's 3xTF32
    (small.big, big.small, big.big), 1 a single TF32 product."""
    (ab, as_), (bb, bs) = split(a), split(b)
    order = ([(as_, bb), (ab, bs), (ab, bb)] if terms == 3
             else [(ab, bb)])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in order:
            part = np.matmul(x[..., k0:k0 + 8].astype(np.float64),
                             y[..., k0:k0 + 8, :].astype(np.float64))
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def emulate(q, k, v, scale, terms=3):
    """(B, N, H, D) f32 numpy -> the kernel's arithmetic, (B, N, H, D)."""
    B, N, H, D = q.shape
    dp, npad = -(-D // 8) * 8, -(-N // 8) * 8

    def heads(t, rows, cols):  # (B, H, rows, cols), zero padding
        out = np.zeros((B, H, rows, cols), np.float32)
        out[:, :, :N, :D] = t.transpose(0, 2, 1, 3)
        return out

    qh, kh, vh = heads(q, N, dp), heads(k, npad, dp), heads(v, npad, dp)
    s = mma_steps(np.zeros((B, H, N, npad), np.float32), qh,
                  kh.transpose(0, 1, 3, 2), terms)
    s = s * np.float32(scale)
    s[..., N:] = -np.inf
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    p = e / e.sum(axis=-1, keepdims=True)
    o = mma_steps(np.zeros((B, H, N, dp), np.float32), p, vh, terms)
    return o[..., :D].transpose(0, 2, 1, 3)


def within(got, ref) -> tuple:
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    worst = float(np.max(err / np.maximum(np.abs(ref), 1.0)))
    return worst, float(np.mean(err))


def _qkv(B, N, H, D):
    rng = np.random.RandomState(N * 1000 + D)
    return [rng.randn(B, N, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,N,H,D", SHAPES)
def test_3xtf32_emulation_holds_the_card_limit(B, N, H, D):
    q, k, v = _qkv(B, N, H, D)
    scale = D**-0.5
    got = emulate(q, k, v, scale)
    plain = tat.mha_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                          scale).numpy()
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    pallas = np.asarray(jap.mha_fused(jq, jk, jv, scale, interpret=True))
    for ref in (plain, pallas):
        worst, mean = within(got, ref)
        assert worst <= REL and mean <= MEAN, (worst, mean)


def test_one_tf32_product_misses_the_limit():
    """The split is what holds the limit: big.big alone (about three
    decimal digits an operand) is far outside it at HaMeR's shape."""
    q, k, v = _qkv(2, 192, 4, 80)
    plain = tat.mha_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                          80**-0.5).numpy()
    worst, _ = within(emulate(q, k, v, 80**-0.5, terms=1), plain)
    assert worst > 10 * REL
    assert within(emulate(q, k, v, 80**-0.5), plain)[0] <= REL


def test_rna_rounds_half_away_from_zero_into_the_exponent():
    x = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12,
                  2 - 2.0**-12, 3.0], np.float32)
    assert rna_tf32(x).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1.0,
                                    2.0, 3.0]
    big, small = split(np.float32([np.pi]))
    assert abs(float(big[0]) + float(small[0]) - np.pi) <= 2.0**-21


def _meta_qkv(N, D, B=2, H=2):
    """(B, N, H, D) f32 slices of a fused meta qkv."""
    qkv = torch.zeros(B, N, 3, H, D, device="meta")
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# (N, D, mode): the tensor-core route (0) up to 256 tokens and head dim 128
# (D padded to 8; 4-byte copies where D % 4 != 0), the CUDA-core loop (7)
# past them or where the tensor-core route's K and V do not fit
TAKEN = [(192, 80, 0), (256, 64, 0), (145, 128, 0), (24, 16, 0), (192, 72, 0),
         (50, 20, 0), (33, 18, 0), (1, 1, 0), (300, 64, 7), (217, 121, 7),
         (100, 256, 7), (1400, 16, 7)]


@pytest.mark.parametrize("N,D,mode", TAKEN)
def test_f32_routes_reach_one_launch(N, D, mode):
    with mock.patch.object(tat, "on_cpu", lambda t: False), \
            mock.patch.object(tat.LIBRARY, "launch") as launch:
        before = dict(tat.launches)
        tat.mha_fused(*_meta_qkv(N, D), D**-0.5)
    assert launch.call_count == 1
    assert launch.call_args.args[-1] == mode
    name = "mha_fused_f32" if mode == 0 else "mha_fused_f32_cores"
    assert {k: v - before[k] for k, v in tat.launches.items()} == {
        k: int(k == name) for k in tat.launches}


@pytest.mark.parametrize("N,D", [(256, 128), (300, 128), (1500, 64),
                                 (64, 1024)])
def test_f32_routes_refuse_past_shared_memory(N, D):
    with mock.patch.object(tat, "on_cpu", lambda t: False), \
            mock.patch.object(tat.LIBRARY, "launch") as launch, \
            pytest.raises(ValueError, match="shared memory"):
        tat.mha_fused(*_meta_qkv(N, D), D**-0.5)
    assert launch.call_count == 0


def test_cuda_core_route_alone_takes_only_f32_cuda_tensors():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        tat.mha_f32_cores(q, q, q, 0.25)
