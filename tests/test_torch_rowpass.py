"""The row passes of the port that run as a warp per row on the card:
K5/K6's LayerNorm + quantise (``ops/vit_block_int8.ln_quant``), K8's
LayerNorm knock-outs (``ops/vit_block_ablation.ln_ablation``: ``ln_cast``
and ``ln_affine_quant``) and K8's two head relayouts
(``heads_split`` and ``heads_merge_quant``).

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
  width is checked;
- ``ln_cast`` (the LayerNorm and XLA's truncating cast, mode ``no_quant``)
  is emulated in the kernel's order and held to its twin as ``ln_quant``
  is, and the twin to the JAX probe's ``_layernorm_f32(.).astype(int8)``;
- the twin of ``heads_merge_quant`` is held bit for bit to the probe's
  relayout and ``_quant_static(oh * inv_proj)``, and a numpy walk of the
  kernel's indices (a warp per output row, lanes over 16- or 4-byte
  vectors, one division then adds) to the twin.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.ops.vit_block_pallas import _layernorm_f32, _quant_static
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


# ------------------------------------------------ K8's LayerNorm knock-out
def xla_cast(y):
    """XLA's f32 -> int8 ``astype``: truncation toward zero, saturation at
    [-128, 127], NaN -> 0 (``abl.cast_i8``)."""
    y = np.nan_to_num(np.asarray(y, F32), nan=0.0)
    return np.trunc(np.clip(y, -128, 127)).astype(np.int8)


def ln_cast_lanes(x, scale, bias, eps=1e-6):
    """The ``ln_cast`` kernel's arithmetic in numpy f32: :func:`lane_stats`,
    the flax LayerNorm in its f32 order (``common.cuh:ln_affine``), then the
    bare cast."""
    x = np.asarray(x, F32)
    mu, msq = lane_stats(x)
    var = np.maximum(msq - mu * mu, F32(0))
    r = F32(1) / np.sqrt(var + F32(eps))
    return xla_cast((x - mu) * (r * scale) + bias)


def _ln_params(rng, C, mul):
    scale = ((1.0 + 0.1 * rng.randn(C)) * mul).astype(F32)
    bias = (0.1 * rng.randn(C) * mul).astype(F32)
    return scale, bias


def _steps(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return int(d.max()), int((d > 0).sum())


@pytest.mark.parametrize("C", [768, 1280])
def test_ln_cast_lane_order_within_compare_int8(C):
    """The kernel's lane-then-butterfly order against the twin
    ``ln_ablation_plain(cast=True)`` within ``compare_int8``'s limits, on
    rows whose mean is 16 spreads (the fast variance cancels), with scale
    and bias times 30 so the values spread over the cast's range; the two
    orders part somewhere, so the comparison sees the order."""
    rng = np.random.RandomState(C + 1)
    x = torch.from_numpy(_rows(rng, 512, C, 16.0)).to(torch.bfloat16)
    scale, bias = _ln_params(rng, C, 30.0)
    got = ln_cast_lanes(x.float().numpy(), scale, bias)
    ref = abl.ln_ablation_plain(x, torch.from_numpy(scale),
                                torch.from_numpy(bias), False, True).numpy()
    worst, moved = _steps(got, ref)
    assert worst <= INT8_MAX_STEP and moved <= INT8_MAX_SHARE * got.size, (
        worst, moved)
    assert moved > 0, "the emulation agrees with the twin everywhere"


def test_ln_cast_lanes_is_the_twin_where_sums_are_exact():
    """Rows of small integers at C = 256 (a power of two: the twin's
    division by C is the kernel's product with RN(1 / C)) sum exactly in any
    order: there the emulation is the twin bit for bit."""
    rng = np.random.RandomState(4)
    x = rng.randint(-8, 9, (64, 256)).astype(F32)
    scale, bias = _ln_params(rng, 256, 30.0)
    got = ln_cast_lanes(x, scale, bias)
    ref = abl.ln_ablation_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(bias), False, True)
    np.testing.assert_array_equal(got, ref.numpy())
    assert (got != 0).mean() > 0.5  # the cast sees the int8 range


def _jax_ln_cast(x32, scale, bias):
    """The JAX probe's ``no_quant`` LayerNorm: ``quant(ln(x32, s, b))`` with
    ``quant`` the bare ``astype(jnp.int8)`` (``_ablation_kernel``)."""
    fn = jax.jit(lambda a, s, b: _layernorm_f32(a, s, b).astype(jnp.int8))
    return np.asarray(fn(x32, scale, bias))


def test_ln_cast_twin_is_the_jax_probe():
    """The twin against ``_layernorm_f32(.).astype(int8)`` compiled by XLA
    on the same bf16 rows: bit for bit where the sums are exact (small
    integers, C = 256), and within ``compare_int8``'s limits on rows with a
    large mean over a small spread, where XLA sums in its own order."""
    rng = np.random.RandomState(6)
    xi = rng.randint(-8, 9, (64, 256)).astype(F32)
    scale, bias = _ln_params(rng, 256, 30.0)
    twin = abl.ln_ablation_plain(torch.from_numpy(xi), torch.from_numpy(scale),
                                 torch.from_numpy(bias), False, True)
    np.testing.assert_array_equal(twin.numpy(),
                                  _jax_ln_cast(xi, scale, bias))
    x = torch.from_numpy(_rows(rng, 256, 1280, 16.0)).to(torch.bfloat16)
    scale, bias = _ln_params(rng, 1280, 30.0)
    twin = abl.ln_ablation_plain(x, torch.from_numpy(scale),
                                 torch.from_numpy(bias), False, True)
    worst, moved = _steps(twin.numpy(),
                          _jax_ln_cast(x.float().numpy(), scale, bias))
    assert worst <= INT8_MAX_STEP and moved <= INT8_MAX_SHARE * twin.numel(), (
        worst, moved)


@pytest.mark.parametrize("no_ln,cast", [(False, True), (True, False)])
@pytest.mark.parametrize("C,ok", [(1280, True), (2048, True), (8, True),
                                  (1284, False), (2056, False), (4, False)])
def test_ln_ablation_width_limits(C, ok, no_ln, cast):
    """``ln_cast`` and ``ln_affine_quant`` take ``ln_quant``'s widths (the
    row in one warp's registers); the wrapper refuses the rest on the kernel
    path, before any launch."""
    meta = torch.zeros(4, C, dtype=torch.bfloat16, device="meta")
    ones = torch.ones(C, device="meta")
    with mock.patch.object(abl, "on_cpu", lambda t: False), \
            mock.patch.object(abl.LIBRARY, "launch") as launch:
        if ok:
            abl.ln_ablation(meta, ones, ones, no_ln, cast)
        else:
            with pytest.raises(ValueError, match="multiple of 8 up to 2048"):
                abl.ln_ablation(meta, ones, ones, no_ln, cast)
    assert launch.call_count == int(ok)


@pytest.mark.parametrize("no_ln,cast", [(False, False), (True, True)])
def test_ln_ablation_takes_one_knock_out(no_ln, cast):
    """Neither knock-out is ``ln_quant``, both are no mode of the probe: the
    wrapper refuses them before any launch."""
    meta = torch.zeros(4, 1280, dtype=torch.bfloat16, device="meta")
    ones = torch.ones(1280, device="meta")
    with mock.patch.object(abl, "on_cpu", lambda t: False), \
            mock.patch.object(abl.LIBRARY, "launch") as launch, \
            pytest.raises(ValueError, match="one knock-out"):
        abl.ln_ablation(meta, ones, ones, no_ln, cast)
    assert launch.call_count == 0


# ------------------------------------------- K8's merge of the heads back
MERGE_SHAPES = [(1, 13, 3, 80), (1, 13, 3, 6), (1, 13, 3, 64), (2, 7, 2, 10)]


def _merge_inputs(B, N, H, D, seed):
    """o (B*H, N, D) and inv (H*D,) in numpy f32: products over and past
    the int8 range, with exact half-integers (inv 1 on every third channel,
    o = k + 0.5 on every fifth entry) for round-half-to-even."""
    rng = np.random.RandomState(seed)
    o = rng.randn(B * H, N, D).astype(F32)
    o.reshape(-1)[::5] = rng.randint(-130, 130, o.size // 5 + 1)[
        :o.reshape(-1)[::5].size] + F32(0.5)
    inv = rng.uniform(10.0, 60.0, H * D).astype(F32)
    inv[::3] = 1.0
    return o, inv


@pytest.mark.parametrize("B,N,H,D", MERGE_SHAPES)
def test_heads_merge_quant_twin_is_the_jax_probe(B, N, H, D):
    """Bit for bit against ``attn_merged``'s ``jnp.transpose`` of the
    attention output back to tokens and ``_quant_static(oh * inv_proj)``
    (``scripts/vith_int8_ablation.py``), at the ragged shapes
    ``chip_smoke.py`` runs the kernel at and one more."""
    o, inv = _merge_inputs(B, N, H, D, D)

    def probe(om, inv_proj):
        oh = jnp.transpose(om.reshape(B, H, N, D), (0, 2, 1, 3)).reshape(
            B, N, H * D)
        return _quant_static(oh * inv_proj)

    ref = np.asarray(jax.jit(probe)(o, inv))
    got = abl.heads_merge_quant(torch.from_numpy(o), torch.from_numpy(inv), H)
    assert got.shape == (B, N, H * D) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    y = o.reshape(B, H, N, D).transpose(0, 2, 1, 3).reshape(B, N, -1) * inv
    assert (np.abs(y) > 127.5).any() and (np.abs(y % 1) == 0.5).any()


def merge_walk(o, inv, heads, vec_bytes, unroll=4):
    """The ``heads_merge_quant`` kernel's index walk in numpy: a warp per
    output token row; lane l takes the row's vectors l, l + 32, ... of
    ``vec_bytes / 4`` f32 values, its first (segment, vector) by one
    division and the next ones by adds, ``unroll`` loads before their
    stores; each value is ``clip(round(o * inv))`` in f32."""
    G, N, D = o.shape
    B, w = G // heads, vec_bytes // 4
    segv = D // w
    per_row = heads * segv
    src = o.reshape(-1, w)
    inv_v = inv.reshape(-1, w)
    out = np.full((B * N * per_row, w), 99, np.int8)  # 99: never written
    for row in range(B * N):  # a warp each
        b, n = row // N, row % N
        base_in = (b * heads * N + n) * segv
        head_stride = N * segv
        for lane in range(32):
            seg, v = lane // segv, lane % segv
            dseg, dv = 32 // segv, 32 % segv
            for base in range(lane, per_row, 32 * unroll):
                loaded = []
                for u in range(unroll):
                    if base + 32 * u < per_row:
                        loaded.append(src[base_in + seg * head_stride + v])
                    seg, v = seg + dseg, v + dv
                    if v >= segv:
                        v, seg = v - segv, seg + 1
                for u, r in enumerate(loaded):
                    k = base + 32 * u
                    y = r * inv_v[k]
                    out[row * per_row + k] = np.clip(np.rint(y), -127, 127)
    return out.reshape(B, N, heads * D)


@pytest.mark.parametrize("B,N,H,D,vec_bytes", [
    s + (4,) for s in MERGE_SHAPES] + [
    s + (16,) for s in MERGE_SHAPES if s[3] % 4 == 0])
def test_merge_walk_is_the_twin(B, N, H, D, vec_bytes):
    """The kernel's walk writes every output once, to the twin's value, in
    both vector widths (16 bytes where a head segment is a whole number of
    float4 vectors)."""
    o, inv = _merge_inputs(B, N, H, D, D + 1)
    ref = abl.heads_merge_quant_plain(torch.from_numpy(o),
                                      torch.from_numpy(inv), H).numpy()
    np.testing.assert_array_equal(merge_walk(o, inv, H, vec_bytes), ref)


@pytest.mark.parametrize("D,ptrs,want", [
    (80, (0x1000, 0x2000, 0x3000), 16), (64, (0x1000, 0x2000, 0x3000), 16),
    (12, (0x1000, 0x2000, 0x3000), 16), (80, (0x1004, 0x2000, 0x3000), 4),
    (80, (0x1000, 0x2008, 0x3000), 4), (6, (0x1000, 0x2000, 0x3000), 4),
    (10, (0x1000, 0x2000, 0x3000), 4)])
def test_merge_vector_bytes(D, ptrs, want):
    """16-byte reads need whole float4 vectors a head segment (D % 4 == 0)
    and 16-byte aligned pointers; anything else takes the 4-byte form."""
    assert abl.merge_vector_bytes(D, *ptrs) == want


def test_heads_merge_quant_refusals_and_width():
    """On the kernel path the wrapper refuses head rows that do not divide
    into the heads and an ``o`` that is not contiguous f32, before any
    launch; a shape it takes reaches the launch with the width the helper
    picks (meta tensors start at 0: 16 bytes for D 80, 4 for D 6)."""
    inv = torch.ones(3 * 80, device="meta")
    with mock.patch.object(abl, "on_cpu", lambda t: False), \
            mock.patch.object(abl.LIBRARY, "launch") as launch:
        with pytest.raises(ValueError, match="do not divide"):
            abl.heads_merge_quant(torch.zeros(4, 13, 80, device="meta"), inv,
                                  3)
        with pytest.raises(ValueError, match="contiguous f32"):
            abl.heads_merge_quant(torch.zeros(3, 13, 80, device="meta",
                                              dtype=torch.bfloat16), inv, 3)
        with pytest.raises(ValueError, match="contiguous f32"):
            abl.heads_merge_quant(
                torch.zeros(3, 80, 13, device="meta").transpose(1, 2), inv, 3)
        assert launch.call_count == 0
        for D, width in ((80, 16), (6, 4)):
            abl.heads_merge_quant(torch.zeros(3, 13, D, device="meta"),
                                  torch.ones(3 * D, device="meta"), 3)
            assert launch.call_args.args[-1] == width
    assert launch.call_count == 2
