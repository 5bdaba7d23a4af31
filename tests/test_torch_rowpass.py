"""The two row passes of the port that run as a warp per row on the card:
K5/K6's LayerNorm + quantise (``ops/vit_block_int8.ln_quant``) and K8's
head-major relayout (``ops/vit_block_ablation.heads_split``).

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their twins. Here:

- a numpy f32 emulation of the ``ln_quant`` kernel's summation order (each
  lane sums its own vectors of 4 values, one accumulator a position, then
  the 32 lane partials meet in a butterfly) is held against the twin
  ``ln_quant_plain`` on the CPU, which sums in another order, within the
  limits ``chip_smoke.compare_int8`` holds the kernel to: one int8 step on at
  most 1e-3 of the entries, row scales within 1e-6 relative. The twin is held
  to the JAX package's ``_layernorm_f32`` + ``_quant_rows_f32`` /
  ``_quant_static`` by ``tests/test_torch_int8.py``. The rows include a
  large mean over a small spread, where the fast variance E[x^2] - E[x]^2
  cancels and a changed order shows: each case also requires that the
  emulation and the twin differ somewhere, so the comparison can see the
  order;
- the wrappers' kernel paths refuse, on meta tensors, what the kernels do
  not take;
- the twin of ``heads_split`` is held bit for bit to the JAX probe's
  ``jnp.transpose`` relayout (``scripts/vith_int8_ablation.py``, mode
  ``attn_merged``) at ragged shapes, and the choice of the kernel's vector
  width is checked.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops import vit_block_ablation as abl
from hands_tpu_torch.ops import vit_block_int8 as t8

F32 = np.float32
INT8_MAX_STEP, INT8_MAX_SHARE, SCALE_REL = 1, 1e-3, 1e-6


def lane_stats(x):
    """(E[x], E[x^2]) of the kernel's rows in numpy f32: lane l holds the
    row's values ``4 (32 i + l) + j``, zeros past the row's end, and keeps
    one accumulator for each j, summing over i in order (``x * x`` rounded
    before its add); it combines them as ((a0 + a1) + a2) + a3; the lane
    sums meet in an xor butterfly over 16, 8, 4, 2, 1 (the order of
    PyTorch's CUDA row reduction); the means are the sums times RN(1 / C),
    as XLA compiles ``jnp.mean`` (the twin on the CPU divides by C)."""
    x = np.asarray(x, F32)
    R, C = x.shape
    nv = -(-C // 128)
    xp = np.zeros((R, nv * 128), F32)
    xp[:, :C] = x
    xv = xp.reshape(R, nv, 32, 4)
    a = np.zeros((R, 32, 4), F32)
    aa = np.zeros((R, 32, 4), F32)
    for i in range(nv):
        a = a + xv[:, i]
        aa = aa + xv[:, i] * xv[:, i]
    lanes = np.arange(32)
    sums = []
    for t in (a, aa):
        t = ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]
        for o in (16, 8, 4, 2, 1):
            t = t + t[:, lanes ^ o]
        sums.append(t[:, :1])
    inv_c = F32(1) / F32(C)
    return sums[0] * inv_c, sums[1] * inv_c


def ln_quant_lanes(x, scale, bias, dynamic, eps=1e-6):
    """The kernel's arithmetic in numpy f32: :func:`lane_stats`, then the
    flax LayerNorm and the quantisation in their f32 order
    (:func:`quant_div`'s quotient is the IEEE one)."""
    x = np.asarray(x, F32)
    mu, msq = lane_stats(x)
    var = np.maximum(msq - mu * mu, F32(0))
    r = F32(1) / np.sqrt(var + F32(eps))
    y = (x - mu) * (r * scale) + bias
    if not dynamic:
        return np.clip(np.rint(y), -127, 127).astype(np.int8), None
    sc = quant.scale_from_amax(
        torch.from_numpy(np.abs(y).max(axis=1, keepdims=True))).numpy()
    return quant_div(y, sc)[0], sc


def quant_div(y, s):
    """The kernel's ``quant_div`` in numpy f32: round y * RN(1 / s) unless
    it lies within 2^-15 of a half-integer, where the IEEE quotient y / s
    decides; then clip to [-127, 127]."""
    y, s = np.asarray(y, F32), np.asarray(s, F32)
    t = y * (F32(1) / s)
    k = np.rint(t)
    near = np.abs(t - k) >= F32(0.5 - 2.0**-15)
    k[near] = np.rint(y[near] / np.broadcast_to(s, y.shape)[near])
    return np.clip(k, -127, 127).astype(np.int8), int(near.sum())


def test_quant_div_is_the_ieee_quotient():
    """The guarded reciprocal rounds like the IEEE division on every value,
    among them the ulps around each half-integer k + 0.5 of the range,
    where the reciprocal's product alone misrounds."""
    rng = np.random.RandomState(11)
    amax = (rng.rand(64) * 10.0 ** rng.uniform(-6, 4, 64)).astype(F32)
    s = quant.scale_from_amax(torch.from_numpy(amax)).numpy()[:, None]
    y = (rng.uniform(-1, 1, (64, 4096)) * amax[:, None]).astype(F32)
    mids = (np.arange(-127, 127) + F32(0.5)).astype(F32) * s  # (64, 254)
    steps = np.arange(-12, 13, dtype=np.int32)
    ties = (mids[..., None].view(np.int32) + steps).view(F32)
    y = np.concatenate([y, ties.reshape(64, -1)], axis=1)
    y = np.clip(y, -amax[:, None], amax[:, None])
    got, near = quant_div(y, s)
    want = np.clip(np.rint(y / s), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)
    naive = np.clip(np.rint(y * (F32(1) / s)), -127, 127).astype(np.int8)
    assert (naive != want).any() and near > 0
    # on values away from the ties the division runs for about 2^-14 of them
    assert quant_div(y[:, :4096], s)[1] < 64 * 4096 * 2.0**-12


def _rows(rng, n, C, cancel_mean):
    """n rows: the odd ones 0.5 + 3 N(0, 1), the even ones 6 (cancel_mean +
    N(0, 1)). (bf16 values have 8 significant bits and their squares 16, so
    narrow rows sum exactly in any order: at C = 160 a bf16 row of mean 96
    shows no order; at 768 and more it does.)"""
    x = (0.5 + 3.0 * rng.randn(n, C)).astype(F32)
    x[::2] = (6.0 * (cancel_mean + rng.randn(n // 2, C))).astype(F32)
    return x


# The even rows' mean over their spread. Static: 16, where E[x^2] is 257
# times the variance. Dynamic: 1; its row scale carries half the variance's
# relative error, and at a mean of 16 the two orders' scales part by 3e-5 to
# 8e-5, past the 1e-6 the kernel is held to (the step shares stay within 1e-3)
@pytest.mark.parametrize("C", [768, 1280])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dynamic,cancel_mean,mul", [(True, 1.0, 1.0),
                                                     (False, 16.0, 30.0)])
def test_ln_quant_lane_order_within_compare_int8(C, dtype, dynamic,
                                                 cancel_mean, mul):
    """The lane-then-butterfly order against the twin: within the card's
    limits, and apart from the twin somewhere. The static form's scale and
    bias arrive pre-divided by an activation scale (here 1/30), so its
    values spread over the int8 range."""
    rng = np.random.RandomState(C + 7 * dynamic)
    x = torch.from_numpy(_rows(rng, 512, C, cancel_mean)).to(dtype)
    scale = ((1.0 + 0.1 * rng.randn(C)) * mul).astype(F32)
    bias = (0.1 * rng.randn(C) * mul).astype(F32)
    q, s = ln_quant_lanes(x.float().numpy(), scale, bias, dynamic)
    q_ref, s_ref = t8.ln_quant_plain(x, torch.from_numpy(scale),
                                     torch.from_numpy(bias), dynamic)
    d = np.abs(q.astype(np.int32) - q_ref.numpy().astype(np.int32))
    moved = int((d > 0).sum())
    assert d.max() <= INT8_MAX_STEP and moved <= INT8_MAX_SHARE * d.size, (
        d.max(), moved)
    parted = moved
    if dynamic:
        s_rel = np.abs(s - s_ref.numpy()) / s_ref.numpy()
        assert s_rel.max() <= SCALE_REL, s_rel.max()
        parted += int((s_rel > 0).sum())
    assert parted > 0, "the emulation agrees with the twin everywhere"


def test_ln_quant_lanes_is_the_twin_where_sums_are_exact():
    """Rows of small integers sum exactly in any order: there the emulation
    is the twin bit for bit, dynamic and static (its arithmetic after the
    sums is the twin's)."""
    rng = np.random.RandomState(3)
    x = rng.randint(-8, 9, (64, 256)).astype(F32)
    scale = (1.0 + 0.1 * rng.randn(256)).astype(F32)
    bias = (0.1 * rng.randn(256)).astype(F32)
    for dynamic, mul in ((True, 1.0), (False, 30.0)):
        q, s = ln_quant_lanes(x, scale * F32(mul), bias * F32(mul), dynamic)
        q_ref, s_ref = t8.ln_quant_plain(
            torch.from_numpy(x), torch.from_numpy(scale * F32(mul)),
            torch.from_numpy(bias * F32(mul)), dynamic)
        np.testing.assert_array_equal(q, q_ref.numpy())
        if dynamic:
            np.testing.assert_array_equal(s, s_ref.numpy())


def test_lane_means_are_jax_means_where_sums_are_exact():
    """On rows whose sums are exact in any order, the kernel's E[x] and
    E[x^2] are bit for bit ``jnp.mean`` of x and of x * x, as
    ``_layernorm_f32`` takes them (XLA compiles the mean to the sum times
    RN(1 / C)), at C = 1280, where that differs from a division by C."""
    x = np.random.RandomState(5).randint(-8, 9, (256, 1280)).astype(F32)
    x += F32(0.25)
    mean = jax.jit(lambda a: jnp.mean(a, axis=-1, keepdims=True))
    mu, msq = lane_stats(x)
    np.testing.assert_array_equal(mu, np.asarray(mean(x)))
    np.testing.assert_array_equal(msq, np.asarray(mean(x * x)))
    s = x.sum(axis=1)
    assert (s * (F32(1) / F32(1280)) != s / F32(1280)).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,ok", [(1280, True), (2048, True), (8, True),
                                  (1284, False), (2056, False), (4, False)])
def test_ln_quant_width_limits(C, ok, dtype):
    """The kernel takes C a multiple of 8 up to 2048 (vectors of 4 values,
    the row in one warp's registers), bf16 or f32 rows; its wrapper refuses the
    rest on the kernel path, before any launch. Meta tensors reach the
    kernel path with ``on_cpu`` patched; a width it takes reaches the
    launch."""
    meta = torch.zeros(4, C, dtype=dtype, device="meta")
    ones = torch.ones(C, device="meta")
    with mock.patch.object(t8, "on_cpu", lambda t: False), \
            mock.patch.object(t8.LIBRARY, "launch") as launch:
        if ok:
            t8.ln_quant(meta, ones, ones, True)
        else:
            with pytest.raises(ValueError, match="multiple of 8 up to 2048"):
                t8.ln_quant(meta, ones, ones, True)
    assert launch.call_count == int(ok)


def test_heads_split_refuses_an_odd_head_dim():
    """D = 5: the kernel's narrowest vector is two bf16 values."""
    meta = torch.zeros(1, 13, 3 * 3 * 5, dtype=torch.bfloat16, device="meta")
    with mock.patch.object(abl, "on_cpu", lambda t: False), \
            mock.patch.object(abl.LIBRARY, "launch") as launch, \
            pytest.raises(ValueError, match="even head dim"):
        abl.heads_split(meta, 3)
    assert launch.call_count == 0


@pytest.mark.parametrize("D,ptrs,want", [
    (80, (0x1000, 0x2000), 16), (64, (0x1000, 0x2000), 16),
    (80, (0x1004, 0x2000), 4), (80, (0x1000, 0x2008), 4),
    (6, (0x1000, 0x2000), 4), (12, (0x1000, 0x2000), 4)])
def test_split_vector_bytes(D, ptrs, want):
    """16-byte vectors need whole vectors a head segment and 16-byte
    aligned pointers; anything else takes the 4-byte form."""
    assert abl.split_vector_bytes(D, *ptrs) == want


def _jax_relayout(qkv, heads):
    """``scripts/vith_int8_ablation.py``'s attn_merged relayout of q, k and
    v: ``jnp.transpose(qkv4[:, :, s], (0, 2, 1, 3)).reshape(TB * H, N,
    D)``."""
    TB, N, C3 = qkv.shape
    D = C3 // 3 // heads
    qkv4 = qkv.reshape(TB, N, 3, heads, D)
    return np.stack([np.asarray(
        jnp.transpose(qkv4[:, :, s], (0, 2, 1, 3)).reshape(TB * heads, N, D),
        np.float32) for s in range(3)])


@pytest.mark.parametrize("B,N,H,D", [(1, 13, 3, 80), (1, 13, 3, 6),
                                     (1, 13, 3, 64), (2, 7, 2, 10)])
def test_heads_split_twin_is_the_jax_relayout(B, N, H, D):
    """Bit for bit, at the ragged shapes ``chip_smoke.py`` runs the kernel
    at (B = 1, N = 13, H = 3, D 80 / 6 / 64) and one more."""
    rng = np.random.RandomState(D)
    x = rng.randn(B, N, 3 * H * D).astype(np.float32)
    qkv = torch.from_numpy(x).to(torch.bfloat16)
    ref = _jax_relayout(jnp.asarray(qkv.float().numpy(), jnp.bfloat16), H)
    got = abl.heads_split(qkv, H)
    assert got.shape == (3, B * H, N, D) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), ref)
