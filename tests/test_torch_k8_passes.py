"""K8's two bf16 -> int8 vector passes (``ops/vit_block_ablation.py``):
``cast_rows`` (mode ``mm_only``: XLA's bare cast of the tokens) and
``qslice_quant`` (mode ``no_attn``: the q third of qkv times ``inv_proj``,
rounded and clipped).

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them bit
for bit against their twins. Here:

- the twins are held bit for bit to the JAX probe
  (``scripts/vith_int8_ablation.py``): ``cast_rows_plain`` to
  ``x.astype(f32).astype(int8)`` on bf16 tensors holding NaN, +-inf, +-0,
  values at and past the int8 range and bf16 subnormals; ``qslice_quant_plain``
  to ``_quant_static(qkv[..., :C].astype(f32) * inv)`` at ragged widths, with
  products past +-127 and on exact .5 ties;
- a numpy walk of each kernel's indices, in every vector width, writes every
  output exactly once, to the twin's value: ``cast_rows`` as a grid that
  strides over vectors of W values with 4 loads in flight and a tail of
  ``n % W`` values; ``qslice_quant`` as a warp per token row, lane l on the
  row's vectors l, l + 32, ...;
- the width pickers, and the wrappers' kernel paths on meta tensors: what
  they refuse before any launch and the width they hand the C entry.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hands_tpu.ops.vit_block_pallas import _quant_static
from hands_tpu_torch.ops import vit_block_ablation as abl

F32 = np.float32
CAST_UNROLL, QSLICE_UNROLL = 4, 8  # the kernels' loads in flight a thread
# bf16 values at the edges of XLA's bare cast: NaN, infinities, signed
# zeros, at and past the int8 range, huge, and subnormals (bf16 keeps f32's
# exponent range: 2^-133 is its least subnormal)
EDGES = [np.nan, np.inf, -np.inf, 0.0, -0.0, 127.5, -127.5, 128.0, -128.0,
         129.0, -129.0, 1e30, -1e30, 2.0**-133, -(2.0**-133), 2.0**-127,
         -1e-39, 0.99, -0.99, 1.5, -1.5]
CAST_SIZES = [1, 7, 9, 13 * 1283]
# (rows, C3): C = C3 // 3 of 8, 128, 1280 (16-byte form), 1284, 130 (4-byte
# form), 3 (one value a step), and two rows whose width is not 3C; the card
# also runs 192 rows, one crop (chip_smoke.py)
QSLICE_SHAPES = [(1, 24), (13, 384), (64, 3840), (13, 3852), (13, 390),
                 (13, 9), (13, 392), (13, 385)]


def bf16_values(n, seed):
    """n bf16 values as exact f32: every third one of :data:`EDGES` in turn,
    the rest spread over and past the int8 range."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(n) * 150.0).astype(F32)
    k = np.arange(0, n, 3)
    v[k] = np.asarray(EDGES, F32)[np.arange(k.size) % len(EDGES)]
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def cast_np(v):
    return np.trunc(np.clip(np.nan_to_num(v, nan=0.0), -128.0, 127.0)).astype(
        np.int8)


def qslice_inputs(rows, C3, seed):
    """qkv (rows, C3) as exact bf16 values, inv (C3 // 3,): products past the
    int8 range, and exact half-integers (inv 1 on every third channel, qkv
    k + 0.5 on every fifth entry) for round-half-to-even."""
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(rows, C3) * 40.0).astype(F32)
    flat = qkv.reshape(-1)
    flat[::5] = rng.randint(-127, 127, flat[::5].size) + F32(0.5)
    qkv = torch.from_numpy(qkv).to(torch.bfloat16).float().numpy()
    inv = rng.uniform(0.5, 6.0, C3 // 3).astype(F32)
    inv[::3] = 1.0
    return qkv, inv


@pytest.mark.parametrize("n", CAST_SIZES)
def test_cast_rows_twin_is_xla_bf16_cast(n):
    """``mm_only``'s first link, ``x.astype(f32).reshape(R, C)
    .astype(int8)``, on bf16 tokens: bit for bit, edges included."""
    v = bf16_values(n, n)
    ref = np.asarray(jax.jit(lambda a: a.astype(jnp.float32).astype(
        jnp.int8))(v.astype(jnp.bfloat16)))
    x = torch.from_numpy(v).to(torch.bfloat16)
    got = abl.cast_rows(x)
    assert got.dtype == torch.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(abl.cast_rows_plain(x).numpy(), ref)
    if n > len(EDGES) * 3:  # every edge and the saturation on both sides
        assert {127, -128} <= set(ref.tolist()) and np.isnan(v).any()


@pytest.mark.parametrize("rows,C3", QSLICE_SHAPES)
def test_qslice_quant_twin_is_the_jax_probe(rows, C3):
    """``no_attn``'s ``quant(qkv[:, :, :C].astype(f32) * inv_proj)``, bit for
    bit, ties and clipping included."""
    C = C3 // 3
    qkv, inv = qslice_inputs(rows, C3, C3)
    ref = np.asarray(jax.jit(lambda q, m: _quant_static(
        q[..., :C].astype(jnp.float32) * m))(
            qkv.astype(jnp.bfloat16)[None], inv))
    qt = torch.from_numpy(qkv).to(torch.bfloat16)[None]
    got = abl.qslice_quant(qt, torch.from_numpy(inv))
    assert got.dtype == torch.int8 and got.shape == (1, rows, C)
    np.testing.assert_array_equal(got.numpy(), ref)
    y = qkv[:, :C] * inv
    assert (np.abs(y % 1) == 0.5).any()
    if C >= 8:
        assert (np.abs(y) > 127.5).any()


# ------------------------------------------------------ the kernels' walks
def cast_walk(v, vec_bytes, threads, resident):
    """The ``cast_rows`` kernel's indices in numpy: n // W vectors of W
    values; a grid of min(vectors / threads, ``resident``) blocks, at least
    one, strides over them, each thread with ``CAST_UNROLL`` loads before
    its stores, then one at a time; thread g < n % W takes tail value g. The
    threads step together. Returns the output and how often each value was
    written."""
    n, W = v.size, vec_bytes // 2
    nvec, tail = n // W, n % W
    blocks = max(1, min(-(-nvec // threads), resident))
    stride = blocks * threads
    x = v[:nvec * W].reshape(nvec, W)
    out, writes = np.zeros(n, np.int8), np.zeros(n, np.int64)
    vec_out, vec_writes = out[:nvec * W].reshape(nvec, W), writes[
        :nvec * W].reshape(nvec, W)

    def store(idx):
        vec_out[idx] = cast_np(x[idx])
        np.add.at(vec_writes, idx, 1)

    i = np.arange(stride)
    while True:  # the unrolled loop
        go = i + (CAST_UNROLL - 1) * stride < nvec
        if not go.any():
            break
        for u in range(CAST_UNROLL):
            store(i[go] + u * stride)
        i[go] += CAST_UNROLL * stride
    while (i < nvec).any():  # one vector at a time
        go = i < nvec
        store(i[go])
        i[go] += stride
    g = np.arange(stride)[:tail]
    out[nvec * W + g] = cast_np(v[nvec * W + g])
    np.add.at(writes, nvec * W + g, 1)
    return out, writes


@pytest.mark.parametrize("vec_bytes", [16, 4, 2])
@pytest.mark.parametrize("n", CAST_SIZES)
@pytest.mark.parametrize("threads,resident", [(32, 2), (256, 132 * 8)])
def test_cast_walk_is_the_twin(n, vec_bytes, threads, resident):
    """Every value written once, to the twin's value, in each form; (32, 2)
    runs the unrolled loop and its remainder, (256, 1056) the card's grid
    (132 SMs, 8 blocks each)."""
    v = bf16_values(n, n + vec_bytes)
    out, writes = cast_walk(v, vec_bytes, threads, resident)
    assert (writes == 1).all()
    ref = abl.cast_rows_plain(torch.from_numpy(v).to(torch.bfloat16))
    np.testing.assert_array_equal(out, ref.numpy())


def qslice_walk(qkv, inv, vec_bytes):
    """The ``qslice_quant`` kernel's indices in numpy: a warp per token row
    (the rows step together); lane l takes the row's vectors l, l + 32, ...
    of W values, ``QSLICE_UNROLL`` loads before their stores, inv's W values
    beside each; each value is ``clip(round(f32(x) * inv))``."""
    rows, C3 = qkv.shape
    C, W = C3 // 3, vec_bytes // 2
    assert C % W == 0 and C3 % W == 0, "a width the C entry refuses"
    nvec = C // W
    src = qkv.reshape(rows, C3 // W, W)
    out = np.zeros((rows, nvec, W), np.int8)
    writes = np.zeros((rows, nvec), np.int64)
    for lane in range(32):
        for base in range(lane, nvec, 32 * QSLICE_UNROLL):
            ks = [base + 32 * u for u in range(QSLICE_UNROLL)
                  if base + 32 * u < nvec]
            loaded = [src[:, k] for k in ks]
            for k, r in zip(ks, loaded):
                y = r * inv[k * W:(k + 1) * W]
                out[:, k] = np.clip(np.rint(y), -127, 127)
                writes[:, k] += 1
    return out.reshape(rows, C), writes


@pytest.mark.parametrize("rows,C3,vec_bytes", [
    s + (vec,) for s in QSLICE_SHAPES for vec in (16, 4, 2)
    if (s[1] // 3) % (vec // 2) == 0 and s[1] % (vec // 2) == 0])
def test_qslice_walk_is_the_twin(rows, C3, vec_bytes):
    """Every output written once, to the twin's value, in each form that C
    and the row stride allow."""
    qkv, inv = qslice_inputs(rows, C3, C3 + vec_bytes)
    out, writes = qslice_walk(qkv, inv, vec_bytes)
    assert (writes == 1).all()
    ref = abl.qslice_quant_plain(torch.from_numpy(qkv).to(torch.bfloat16),
                                 torch.from_numpy(inv))
    np.testing.assert_array_equal(out, ref.numpy())


# ---------------------------------------------- widths and the kernel path
@pytest.mark.parametrize("x_ptr,q_ptr,want", [
    (0x1000, 0x2000, 16), (0x1000, 0x2008, 16), (0x1002, 0x2000, 2),
    (0x1004, 0x2000, 4), (0x1000, 0x2004, 4), (0x1000, 0x2002, 4),
    (0x1000, 0x2001, 2), (0x100c, 0x2000, 4)])
def test_cast_vector_bytes(x_ptr, q_ptr, want):
    """16-byte loads need x at 16 bytes and q at 8; 4-byte loads x at 4 and
    q at 2; else one value a step."""
    assert abl.cast_vector_bytes(x_ptr, q_ptr) == want


@pytest.mark.parametrize("C,stride,ptrs,want", [
    (1280, 3840, (0x1000, 0x2000, 0x3000), 16),
    (8, 24, (0x1000, 0x2000, 0x3000), 16),
    (1284, 3852, (0x1000, 0x2000, 0x3000), 4),
    (130, 390, (0x1000, 0x2000, 0x3000), 4),
    (130, 392, (0x1000, 0x2000, 0x3000), 4),
    (128, 385, (0x1000, 0x2000, 0x3000), 2),
    (3, 9, (0x1000, 0x2000, 0x3000), 2),
    (1280, 3840, (0x1004, 0x2000, 0x3000), 4),
    (1280, 3840, (0x1000, 0x2008, 0x3000), 4),
    (1280, 3840, (0x1000, 0x2000, 0x3004), 4),
    (1280, 3840, (0x1000, 0x2004, 0x3000), 2)])
def test_qslice_vector_bytes(C, stride, ptrs, want):
    """16 bytes where C and the row stride are multiples of 8, qkv and inv
    16-byte and out 8-byte aligned; 4 where both are even, qkv at 4, inv at
    8, out at 2; else one value a step."""
    assert abl.qslice_vector_bytes(C, stride, *ptrs) == want


def _kernel_path():
    return (mock.patch.object(abl, "on_cpu", lambda t: False),
            mock.patch.object(abl.LIBRARY, "launch"))


def test_cast_rows_kernel_path():
    """The wrapper refuses what is not contiguous bf16 before any launch;
    otherwise it hands the C entry the count and the picked width (meta
    tensors start at 0: 16 bytes)."""
    on_cpu, launch_patch = _kernel_path()
    before = abl.launches["cast_rows"]
    with on_cpu, launch_patch as launch:
        with pytest.raises(ValueError, match="contiguous bf16"):
            abl.cast_rows(torch.zeros(13, 1283, device="meta"))
        with pytest.raises(ValueError, match="contiguous bf16"):
            abl.cast_rows(torch.zeros(1283, 13, dtype=torch.bfloat16,
                                      device="meta").t())
        assert launch.call_count == 0
        q = abl.cast_rows(torch.zeros(13, 1283, dtype=torch.bfloat16,
                                      device="meta"))
        assert launch.call_args.args[0] == "abl_cast_rows"
        assert launch.call_args.args[-2:] == (13 * 1283, 16)
    assert q.shape == (13, 1283) and q.dtype == torch.int8
    assert abl.launches["cast_rows"] == before + 1
    abl.launches["cast_rows"] = before


@pytest.mark.parametrize("C3,width", [(3840, 16), (3852, 4), (390, 4),
                                      (385, 2), (9, 2)])
def test_qslice_quant_kernel_path(C3, width):
    """Every width the parent took reaches the C entry with the row count,
    C, the row stride and the width the helper picks; an ``inv`` of the
    wrong length or a qkv that is not bf16 is refused before any launch."""
    C = C3 // 3
    on_cpu, launch_patch = _kernel_path()
    before = abl.launches["qslice_quant"]
    qkv = torch.zeros(2, 13, C3, dtype=torch.bfloat16, device="meta")
    with on_cpu, launch_patch as launch:
        with pytest.raises(ValueError):
            abl.qslice_quant(qkv, torch.ones(C + 1, device="meta"))
        with pytest.raises(ValueError):
            abl.qslice_quant(qkv.float(), torch.ones(C, device="meta"))
        assert launch.call_count == 0
        out = abl.qslice_quant(qkv, torch.ones(C, device="meta"))
        assert launch.call_args.args[0] == "abl_qslice_quant"
        assert launch.call_args.args[-4:] == (26, C, C3, width)
    assert out.shape == (2, 13, C) and out.dtype == torch.int8
    assert abl.launches["qslice_quant"] == before + 1
    abl.launches["qslice_quant"] = before
