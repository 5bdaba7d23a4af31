"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernels (the bf16 ViT block, the two W8A8 ViT blocks, the fused attention),
holds each against its plain PyTorch twin at ViT-H shapes, serves requests
through HaMeR at full ViT-H width and depth in its bf16, dynamic-int8 and
calibrated static-int8 configurations (and one backbone forward with the
fused attention), checks the launch counts of each path, and times kernels,
blocks and serving with CUDA events.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and this repository;
never imports JAX. Exits non-zero on any failed phase, without a card, and
outside the repository. The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launch count on its path, error against the twin, times (kernel,
twin, one PyTorch library call where there is one) and roofline bound.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH = 16  # crops: 8 images, two hands each
N_TOK, C, HIDDEN, HEADS = 192, 1280, 5120, 16  # ViT-H
ROWS = BATCH * N_TOK
HEAD_DIM = C // HEADS
MAX_REL, MAX_MEAN = 3e-2, 1e-3  # bf16 kernel vs twin (sum-order flips)
# whole block: a one-ulp flip of the bf16 residual x1 at |x1| in [4, 8) is
# 2^-5 absolute, and it survives where x1 + mlp cancels to |out| < 1
BLOCK_REL = 2.0**-4
# int8 outputs: the kernel and the twin sum a row's statistics (or a head's
# logits) in another order, so a value lying on a rounding boundary may land
# one step apart; never more, and on few elements
INT8_MAX_STEP, INT8_MAX_SHARE = 1, 1e-3
# whole int8 block: one such step is 1/127 of a channel's range and reaches
# the output through a product, so the blocks get the bf16 block's bounds
SERVE_REL = 2e-2  # vertices, kernel path vs twin path, / max(|ref|, 1)
INT8_SERVE_REL = 5e-2  # the same through 32 int8 blocks
VIT = "h"  # full ViT-H width and depth
DEV = torch.device("cuda", 0)
K3 = "hands_tpu/ops/vit_block_pallas.py:382"
K5 = "hands_tpu/ops/vit_block_pallas.py:501"
K6 = "hands_tpu/ops/vit_block_pallas.py:627"
K7 = "hands_tpu/ops/attention_pallas.py:52"
SRC_K3 = "hands_tpu_torch/csrc/vit_block.cu"
SRC_I8 = "hands_tpu_torch/csrc/vit_block_int8.cu"
SRC_ATTN = "hands_tpu_torch/csrc/attention.cu"
# published dense peaks of one H100 SXM: bytes/s of HBM3, operations/s by
# operand type (bf16 and int8 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(ok: bool, what: str) -> None:
    """A check that also holds under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def compare(name, got, ref, rel=MAX_REL, mean=MAX_MEAN) -> float:
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    worst = float((err / r.abs().clamp(min=1.0)).max())
    avg = float(err.mean())
    ok = bool(torch.isfinite(g).all()) and worst <= rel and avg <= mean
    print(f"  {name:<34s} max|d|/max(|ref|,1) {worst:.3e} (<= {rel:g})  "
          f"mean|d| {avg:.3e} (<= {mean:g})  {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its twin")
    return float(err.max())


def compare_int8(name, got, ref) -> float:
    """int8 outputs (and their f32 row scales, which must be equal)."""
    if isinstance(got, tuple):
        (got, s_got), (ref, s_ref) = got, ref
        if s_got is not None:
            s_err = float(((s_got - s_ref).abs() / s_ref).max())
            require(s_err <= 1e-6, f"{name}: row scales differ by {s_err}")
    require(got.dtype == torch.int8 and ref.dtype == torch.int8,
            f"{name}: want int8 outputs")
    d = (got.int() - ref.int()).abs()
    worst, share = int(d.max()), float((d > 0).float().mean())
    ok = worst <= INT8_MAX_STEP and share <= INT8_MAX_SHARE
    print(f"  {name:<34s} max step {worst} (<= {INT8_MAX_STEP})  share moved "
          f"{share:.3e} (<= {INT8_MAX_SHARE:g})  {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its twin")
    return float(worst)


def compare_equal(name, got, ref) -> float:
    """An int8 GEMM on the same int8 inputs: int32 sums are exact and the
    f32 epilogue is evaluated op by op on both sides, so every bit agrees."""
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs().float()
    else:
        d = (got.float() - ref.float()).abs()
    worst, moved = float(d.max()), int((d > 0).sum())
    print(f"  {name:<34s} max|d| {worst:.3e}, {moved} of {d.numel()} differ  "
          f"{'bit-equal' if moved == 0 else 'FAIL'}")
    require(moved == 0, f"{name}: int8 GEMM is not bit-equal to its twin")
    return worst


def compare_gelu_gemm(name, got, ref) -> float:
    """An int8 GEMM with a GELU epilogue: bit-equal unless the two builds of
    erfc/tanh differ in the last place; then at most one f32 ulp (or one int8
    step) on few elements."""
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs().float()
        limit = 1.0
    else:
        d = (got - ref).abs() / ref.abs().clamp(min=2.0**-20)
        limit = 2.0**-22
    worst, share = float(d.max()), float((d > 0).float().mean())
    ok = worst <= limit and share <= INT8_MAX_SHARE
    print(f"  {name:<34s} max {'step' if got.dtype == torch.int8 else 'rel'} "
          f"{worst:.3e} (<= {limit:.3e})  share moved {share:.3e}  "
          f"{'bit-equal' if share == 0 else 'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its twin")
    return float((got.float() - ref.float()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Case:
    """One launch shape of a kernel: how to call the wrapper or the twin
    (``call(fn)``), the library call, the bytes the function must move (each
    input once, each output once) and the operations it does."""

    def __init__(self, label, call, inputs, ops, kind, library=None,
                 check=compare):
        self.label, self.call, self.library = label, call, library
        self.inputs, self.ops, self.kind, self.check = inputs, ops, kind, check

    def bound(self, out) -> tuple:
        outs = out if isinstance(out, tuple) else (out,)
        t_bytes = (nbytes(*self.inputs) + nbytes(*outs)) / HBM_BYTES_S * 1e3
        t_ops = self.ops / PEAK_OPS_S[self.kind] * 1e3
        return t_bytes, t_ops


def block_inputs(gen, dev, batch, n_tok, c, hidden):
    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def f32(*shape, base=0.0):
        return base + 0.1 * torch.randn(shape, generator=gen, device=dev)

    x = randn(batch, n_tok, c)
    p32 = {
        "ln1_scale": f32(c, base=1.0), "ln1_bias": f32(c),
        "wqkv": randn(3 * c, c, std=c**-0.5, dtype=torch.float32),
        "bqkv": randn(3 * c, std=0.1, dtype=torch.float32),
        "wproj": randn(c, c, std=c**-0.5, dtype=torch.float32),
        "bproj": randn(c, std=0.1, dtype=torch.float32),
        "ln2_scale": f32(c, base=1.0), "ln2_bias": f32(c),
        "w1": randn(hidden, c, std=c**-0.5, dtype=torch.float32),
        "b1": randn(hidden, std=0.1, dtype=torch.float32),
        "w2": randn(c, hidden, std=hidden**-0.5, dtype=torch.float32),
        "b2": randn(c, std=0.1, dtype=torch.float32),
    }
    p = {k: v if k.startswith("ln") else v.to(torch.bfloat16)
         for k, v in p32.items()}
    return x, p, p32


def make_requests(n_batches, batch, seed):
    from hands_tpu_torch.cli.demo import make_record, pad_to_common_size

    rng = np.random.RandomState(seed)
    sizes = [(480, 640), (360, 480), (512, 512), (400, 600)]
    batches = []
    for b in range(n_batches):
        recs = []
        for i in range(batch):
            h, w = sizes[(b + i) % len(sizes)]
            img = rng.randint(0, 256, (h, w, 3), np.uint8)

            def box():
                x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
                return np.asarray([x0, y0, x0 + rng.uniform(40, w * 0.4),
                                   y0 + rng.uniform(40, h * 0.4)], np.float32)

            recs.append(make_record(
                f"req{b}_{i}.png", img, box(), box() if i % 3 else None,
                focal=None if i % 2 else float(rng.uniform(500, 1500))))
        pad_to_common_size(recs)
        batches.append(recs)
    return batches


def kernel_cases(x, p, p32):
    """Every kernel of the port with its launch shapes at ViT-H: {kernel
    name: (wrapper, twin, route info, [Case, ...])}."""
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import quant
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8

    bf = torch.bfloat16
    x2 = x.reshape(ROWS, C)
    x32 = x2.float()
    attn_ops = 4 * BATCH * HEADS * N_TOK * N_TOK * HEAD_DIM
    ln_ops = 8 * ROWS * C

    def gemm_ops(n, k):
        return 2 * ROWS * n * k

    def sdpa(qkv3):
        t = qkv3.view(BATCH, N_TOK, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4)
        return lambda: F.scaled_dot_product_attention(t[0], t[1], t[2])

    # ---- K3: bf16 block
    y = vb.layernorm_plain(x2, p["ln1_scale"], p["ln1_bias"])
    qkv = vb.gemm_plain(y, p["wqkv"], p["bqkv"])
    qkv3 = qkv.view(BATCH, N_TOK, 3 * C)
    o = vb.attention_plain(qkv3, HEADS).view(ROWS, C)
    h = vb.gemm_plain(y, p["w1"], p["b1"], "gelu")
    ln_w, ln_b = p["ln1_scale"].to(bf), p["ln1_bias"].to(bf)
    k3 = {
        "vit_layernorm": (vb.layernorm, vb.layernorm_plain, [
            Case("layernorm LN1",
                 lambda f: f(x2, p["ln1_scale"], p["ln1_bias"]),
                 [x2, p["ln1_scale"], p["ln1_bias"]], ln_ops, "f32",
                 lambda: F.layer_norm(x2, (C,), ln_w, ln_b, 1e-6)),
            Case("layernorm LN2",
                 lambda f: f(o, p["ln2_scale"], p["ln2_bias"]),
                 [o, p["ln2_scale"], p["ln2_bias"]], ln_ops, "f32",
                 lambda: F.layer_norm(o, (C,), ln_w, ln_b, 1e-6))]),
        "vit_gemm": (vb.gemm, vb.gemm_plain, [
            Case("gemm qkv", lambda f: f(y, p["wqkv"], p["bqkv"]),
                 [y, p["wqkv"], p["bqkv"]], gemm_ops(3 * C, C), "bf16",
                 lambda: F.linear(y, p["wqkv"], p["bqkv"])),
            Case("gemm proj+residual",
                 lambda f: f(o, p["wproj"], p["bproj"], "residual", x2),
                 [o, p["wproj"], p["bproj"], x2], gemm_ops(C, C), "bf16",
                 lambda: F.linear(o, p["wproj"], p["bproj"])),
            Case("gemm mlp1+gelu",
                 lambda f: f(y, p["w1"], p["b1"], "gelu"),
                 [y, p["w1"], p["b1"]], gemm_ops(HIDDEN, C), "bf16",
                 lambda: F.linear(y, p["w1"], p["b1"])),
            Case("gemm mlp2+residual",
                 lambda f: f(h, p["w2"], p["b2"], "residual", x2),
                 [h, p["w2"], p["b2"], x2], gemm_ops(C, HIDDEN), "bf16",
                 lambda: F.linear(h, p["w2"], p["b2"])),
        ]),
        "vit_attention": (vb.attention, vb.attention_plain, [
            Case("attention", lambda f: f(qkv3, HEADS), [qkv3], attn_ops,
                 "bf16", sdpa(qkv3))]),
    }
    # the tanh-GELU epilogue: checked against its twin, timed with the block
    # shapes outside a row's per-block sum: (case, wrapper, twin)
    extra = [(Case("gemm mlp1+gelu_tanh",
                   lambda f: f(y, p["w1"], p["b1"], "gelu_tanh"),
                   [y, p["w1"], p["b1"]], gemm_ops(HIDDEN, C), "bf16",
                   lambda: F.linear(y, p["w1"], p["b1"])),
              vb.gemm, vb.gemm_plain)]

    # ---- K5: dynamic W8A8 block
    d = quant.prepare_int8(p32)
    qy, sy = v8.ln_quant_plain(x2, d["ln1_s"], d["ln1_b"], True)
    dqkv = v8.gemm_i8_plain(qy, d["wqkv_q"], d["sqkv"], d["bqkv"],
                            row_scale=sy)
    dqkv3 = dqkv.view(BATCH, N_TOK, 3 * C)
    do = at.qkv_attention_plain(dqkv3, HEADS).view(ROWS, C)
    qo, so = v8.quant_rows_plain(do)
    x1 = v8.gemm_i8_plain(qo, d["wproj_q"], d["sproj"], d["bproj"],
                          row_scale=so, epilogue="residual", residual=x32,
                          out_dtype=torch.float32)
    qy2, sy2 = v8.ln_quant_plain(x1, d["ln2_s"], d["ln2_b"], True)
    hm = v8.gemm_i8_plain(qy2, d["w1_q"], d["s1"], d["b1"], row_scale=sy2,
                          epilogue="gelu", out_dtype=torch.float32)
    qh, sh = v8.quant_rows_plain(hm)

    def int_mm(a_q, w_q):
        return lambda: torch._int_mm(a_q, w_q.t())

    def dyn(a_q, s_a, w, s_w, b, **kw):
        return lambda f: f(a_q, d[w], d[s_w], d[b], row_scale=s_a, **kw)

    k5 = {
        "ln_quant_dynamic": (v8.ln_quant, v8.ln_quant_plain, [
            Case("ln_quant dynamic LN1 (bf16 in)",
                 lambda f: f(x2, d["ln1_s"], d["ln1_b"], True),
                 [x2, d["ln1_s"], d["ln1_b"]], ln_ops, "f32",
                 check=compare_int8),
            Case("ln_quant dynamic LN2 (f32 in)",
                 lambda f: f(x1, d["ln2_s"], d["ln2_b"], True),
                 [x1, d["ln2_s"], d["ln2_b"]], ln_ops, "f32",
                 check=compare_int8)]),
        "quant_rows": (v8.quant_rows, v8.quant_rows_plain, [
            Case("quant_rows attention out (bf16)", lambda f: f(do), [do],
                 3 * ROWS * C, "f32", check=compare_int8),
            Case("quant_rows GELU out (f32)", lambda f: f(hm), [hm],
                 3 * ROWS * HIDDEN, "f32", check=compare_int8)]),
        "gemm_i8_dynamic": (v8.gemm_i8, v8.gemm_i8_plain, [
            Case("gemm_i8 dynamic qkv",
                 dyn(qy, sy, "wqkv_q", "sqkv", "bqkv"),
                 [qy, sy, d["wqkv_q"], d["sqkv"], d["bqkv"]],
                 gemm_ops(3 * C, C), "int8", int_mm(qy, d["wqkv_q"]),
                 compare_equal),
            Case("gemm_i8 dynamic proj+residual",
                 dyn(qo, so, "wproj_q", "sproj", "bproj", epilogue="residual",
                     residual=x32, out_dtype=torch.float32),
                 [qo, so, d["wproj_q"], d["sproj"], d["bproj"], x32],
                 gemm_ops(C, C), "int8", int_mm(qo, d["wproj_q"]),
                 compare_equal),
            Case("gemm_i8 dynamic mlp1+gelu",
                 dyn(qy2, sy2, "w1_q", "s1", "b1", epilogue="gelu",
                     out_dtype=torch.float32),
                 [qy2, sy2, d["w1_q"], d["s1"], d["b1"]],
                 gemm_ops(HIDDEN, C), "int8", int_mm(qy2, d["w1_q"]),
                 compare_gelu_gemm),
            Case("gemm_i8 dynamic mlp2+residual",
                 dyn(qh, sh, "w2_q", "s2", "b2", epilogue="residual",
                     residual=x1, out_dtype=bf),
                 [qh, sh, d["w2_q"], d["s2"], d["b2"], x1],
                 gemm_ops(C, HIDDEN), "int8", int_mm(qh, d["w2_q"]),
                 compare_equal),
        ]),
        "qkv_attention_dynamic": (at.qkv_attention, at.qkv_attention_plain, [
            Case("attention dynamic (f32 probs)", lambda f: f(dqkv3, HEADS),
                 [dqkv3], attn_ops, "bf16", sdpa(dqkv3))]),
    }
    extra.append((Case(
        "gemm_i8 dynamic mlp1+gelu_tanh",
        dyn(qy2, sy2, "w1_q", "s1", "b1", epilogue="gelu",
            out_dtype=torch.float32, fast_gelu=True),
        [qy2, sy2, d["w1_q"], d["s1"], d["b1"]], gemm_ops(HIDDEN, C), "int8",
        int_mm(qy2, d["w1_q"]), compare_gelu_gemm),
        v8.gemm_i8, v8.gemm_i8_plain))

    # ---- K6: static W8A8 block, scales from these activations' maxima
    def amax(t):
        return torch.clamp(t.float().abs().amax(0), min=1e-6) / 127.0

    act = {"qkv": amax(vb.layernorm_f32(x32, p["ln1_scale"], p["ln1_bias"])),
           "proj": amax(o), "mlp1": amax(y), "mlp2": amax(h)}
    s = quant.fold_static_scales(p32, act)
    sq, _ = v8.ln_quant_plain(x2, s["ln1_s"], s["ln1_b"], False)
    sqkv = v8.gemm_i8_plain(sq, s["wqkv_q"], s["dqkv"], s["bqkv"])
    sqkv3 = sqkv.view(BATCH, N_TOK, 3 * C)
    sqo = at.qkv_attention_plain(sqkv3, HEADS, s["inv_proj"]).view(ROWS, C)
    sx1 = v8.gemm_i8_plain(sqo, s["wproj_q"], s["dproj"], s["bproj"],
                           epilogue="residual", residual=x2)
    sq2, _ = v8.ln_quant_plain(sx1, s["ln2_s"], s["ln2_b"], False)
    sqh = v8.gemm_i8_plain(sq2, s["w1_q"], s["d1"], s["b1"], epilogue="gelu",
                           inv_next=s["inv_mlp2"])

    def sta(a_q, w, dq, b, **kw):
        return lambda f: f(a_q, s[w], s[dq], s[b], **kw)

    k6 = {
        "ln_quant_static": (v8.ln_quant, v8.ln_quant_plain, [
            Case("ln_quant static LN1",
                 lambda f: f(x2, s["ln1_s"], s["ln1_b"], False),
                 [x2, s["ln1_s"], s["ln1_b"]], ln_ops, "f32",
                 check=compare_int8),
            Case("ln_quant static LN2",
                 lambda f: f(sx1, s["ln2_s"], s["ln2_b"], False),
                 [sx1, s["ln2_s"], s["ln2_b"]], ln_ops, "f32",
                 check=compare_int8)]),
        "gemm_i8_static": (v8.gemm_i8, v8.gemm_i8_plain, [
            Case("gemm_i8 static qkv", sta(sq, "wqkv_q", "dqkv", "bqkv"),
                 [sq, s["wqkv_q"], s["dqkv"], s["bqkv"]],
                 gemm_ops(3 * C, C), "int8", int_mm(sq, s["wqkv_q"]),
                 compare_equal),
            Case("gemm_i8 static proj+residual",
                 sta(sqo, "wproj_q", "dproj", "bproj", epilogue="residual",
                     residual=x2),
                 [sqo, s["wproj_q"], s["dproj"], s["bproj"], x2],
                 gemm_ops(C, C), "int8", int_mm(sqo, s["wproj_q"]),
                 compare_equal),
            Case("gemm_i8 static mlp1+gelu_tanh+quant",  # the served form
                 sta(sq2, "w1_q", "d1", "b1", epilogue="gelu",
                     inv_next=s["inv_mlp2"], fast_gelu=True),
                 [sq2, s["w1_q"], s["d1"], s["b1"], s["inv_mlp2"]],
                 gemm_ops(HIDDEN, C), "int8", int_mm(sq2, s["w1_q"]),
                 compare_gelu_gemm),
            Case("gemm_i8 static mlp2+residual",
                 sta(sqh, "w2_q", "d2", "b2", epilogue="residual",
                     residual=sx1),
                 [sqh, s["w2_q"], s["d2"], s["b2"], sx1],
                 gemm_ops(C, HIDDEN), "int8", int_mm(sqh, s["w2_q"]),
                 compare_equal),
        ]),
        "qkv_attention_static": (at.qkv_attention, at.qkv_attention_plain, [
            Case("attention static (int8 out)",
                 lambda f: f(sqkv3, HEADS, s["inv_proj"]),
                 [sqkv3, s["inv_proj"]], attn_ops, "bf16", sdpa(sqkv3),
                 compare_int8)]),
    }
    extra.append((Case(
        "gemm_i8 static mlp1+gelu+quant",
        sta(sq2, "w1_q", "d1", "b1", epilogue="gelu",
            inv_next=s["inv_mlp2"]),
        [sq2, s["w1_q"], s["d1"], s["b1"], s["inv_mlp2"]],
        gemm_ops(HIDDEN, C), "int8", int_mm(sq2, s["w1_q"]),
        compare_gelu_gemm), v8.gemm_i8, v8.gemm_i8_plain))

    # ---- K7: fused attention on the slices of a fused qkv, bf16 and f32
    q5 = qkv.view(BATCH, N_TOK, 3, HEADS, HEAD_DIM)
    q5f = q5.float()
    scale = HEAD_DIM**-0.5

    def mha(t5):
        return lambda f: f(t5[:, :, 0], t5[:, :, 1], t5[:, :, 2], scale)

    def sdpa5(t5):
        t = t5.permute(2, 0, 3, 1, 4)
        return lambda: F.scaled_dot_product_attention(t[0], t[1], t[2])

    # the backbone's path is bf16; f32 is the JAX test's type (atol 2e-5)
    k7 = {
        "mha_fused": (at.mha_fused, at.mha_plain, [
            Case("mha_fused bf16", mha(q5), [q5], attn_ops, "bf16",
                 sdpa5(q5))]),
    }
    extra.append((Case(
        "mha_fused f32", mha(q5f), [q5f], attn_ops, "f32", sdpa5(q5f),
        lambda n, g, r: compare(n, g, r, rel=2e-5, mean=2e-6)),
        at.mha_fused, at.mha_plain))
    groups = [(K3, SRC_K3, k3), (K5, SRC_I8, k5), (K6, SRC_I8, k6),
              (K7, SRC_ATTN, k7)]
    # the int8 blocks' attention lives in the attention library
    sources = {"qkv_attention_dynamic": SRC_ATTN,
               "qkv_attention_static": SRC_ATTN}
    operands = {"dynamic": d, "static": s}
    return groups, sources, extra, operands


def launch_counts() -> dict:
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8

    out = {f"vit_{k}": v for k, v in vb.launches.items()}
    out.update(v8.launches)
    out.update(at.launches)
    return out


def reset_launch_counts() -> None:
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8

    for mod in (vb, v8, at):
        mod.reset_launches()


def check_launches(path, counts, per_forward, forwards) -> None:
    """Exactly the kernels of this path ran, each ``per_forward`` times per
    forward; every other kernel of the port not at all."""
    for k, n in counts.items():
        want = per_forward.get(k, 0) * forwards
        require(n == want, f"{path}: {k} launched {n} times, want {want}")
    print(f"  {path}: launches per forward {dict(per_forward)} x "
          f"{forwards}, no other kernel: ok")


def check_outputs(outs, batch) -> None:
    for out in outs:
        for side in ("r", "l"):
            v, j = out[f"pred.mano.vertices.{side}"], \
                out[f"pred.mano.joints3d.{side}"]
            require(v.shape == (batch, 778, 3) and j.shape == (batch, 21, 3),
                    f"output shapes {tuple(v.shape)} {tuple(j.shape)}")
            require(bool(torch.isfinite(v).all() and torch.isfinite(j).all()),
                    "non-finite vertices or joints")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli import calibrate as cal
    from hands_tpu_torch.cli.demo import serve, serving_config
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.backbones import vit as vit_mod
    from hands_tpu_torch.models.registry import fetch_model, init_weights_
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.calibration import inject_scales
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = DEV
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {tag}")

    # ---- 1. build: one nvcc per source, all started together
    t0 = time.time()
    reports = build_all([vb.LIBRARY, v8.LIBRARY, at.LIBRARY])
    for lib in (vb.LIBRARY, v8.LIBRARY, at.LIBRARY):
        lib.lib()
    print(f"phase 1: built {SRC_K3}, {SRC_I8}, {SRC_ATTN} side by side in "
          f"{time.time() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())

    # ---- 2. each kernel against its twin at ViT-H shapes
    print(f"phase 2: kernels vs twins, rows={ROWS} C={C} hidden={HIDDEN} "
          f"heads={HEADS} D={HEAD_DIM}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, p, p32 = block_inputs(gen, dev, BATCH, N_TOK, C, HIDDEN)
    groups, sources, extra, operands = kernel_cases(x, p, p32)
    rows = {}  # kernel name -> its line of the kernels JSON
    for replaces, source, kernels in groups:
        for kname, (kfn, pfn, cases) in kernels.items():
            errs, t_bytes, t_ops, bound = [], 0.0, 0.0, 0.0
            for case in cases:
                got, ref = case.call(kfn), case.call(pfn)
                errs.append(case.check(case.label, got, ref))
                b, o = case.bound(ref)
                t_bytes, t_ops = t_bytes + b, t_ops + o
                bound += max(b, o)
            rows[kname] = {
                "name": kname, "route": "cuda",
                "source": sources.get(kname, source), "replaces": replaces,
                "launches": 0, "max_abs_err": max(errs),
                # per block: summed over this kernel's launch shapes
                "bound_ms": bound,
                "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    for case, kfn, pfn in extra:
        case.check(case.label, case.call(kfn), case.call(pfn))
    torch.cuda.synchronize()

    blocks = {}  # name -> (kernel path, twin path) closures, for phase 4
    for fast in (False, True):
        tail = " fast_gelu" if fast else ""
        blocks[f"bf16 block{tail}"] = (
            lambda f=fast: vb.vit_block_fused(x, p, num_heads=HEADS,
                                              fast_gelu=f),
            lambda f=fast: vb.vit_block_plain(x, p, HEADS, f))
        blocks[f"dynamic int8 block{tail}"] = (
            lambda f=fast: v8.vit_block_fused_int8(
                x, operands["dynamic"], num_heads=HEADS, fast_gelu=f),
            lambda f=fast: v8.vit_block_int8_plain(
                x, operands["dynamic"], HEADS, f))
        blocks[f"static int8 block{tail}"] = (
            lambda f=fast: v8.vit_block_fused_int8_static(
                x, operands["static"], num_heads=HEADS, fast_gelu=f),
            lambda f=fast: v8.vit_block_int8_static_plain(
                x, operands["static"], HEADS, f))
    for name, (kern, twin) in blocks.items():
        compare(f"whole {name}", kern(), twin(), rel=BLOCK_REL)
    torch.cuda.synchronize()

    # shapes that are no multiples of the GEMM tiles (128 x 128 x 64) or of
    # the row kernels' 256 threads: 72 rows, C 160 (head dim 80), hidden 320
    from hands_tpu_torch.ops import quant
    rb, rn, rc, rh, rheads = 3, 24, 160, 320, 2
    rx, rp, rp32 = block_inputs(gen, dev, rb, rn, rc, rh)

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    r_dyn = quant.prepare_int8(rp32)
    r_sta = quant.fold_static_scales(rp32, {
        "qkv": uniform(rc, 0.02, 0.05), "proj": uniform(rc, 0.005, 0.02),
        "mlp1": uniform(rc, 0.02, 0.05), "mlp2": uniform(rh, 0.005, 0.03)})
    for fast in (False, True):
        tail = f"(72 rows, C 160{', fast_gelu' if fast else ''})"
        compare(f"bf16 block {tail}",
                vb.vit_block_fused(rx, rp, num_heads=rheads, fast_gelu=fast),
                vb.vit_block_plain(rx, rp, rheads, fast), rel=BLOCK_REL)
        compare(f"dynamic int8 block {tail}",
                v8.vit_block_fused_int8(rx, r_dyn, num_heads=rheads,
                                        fast_gelu=fast),
                v8.vit_block_int8_plain(rx, r_dyn, rheads, fast),
                rel=BLOCK_REL)
        compare(f"static int8 block {tail}",
                v8.vit_block_fused_int8_static(rx, r_sta, num_heads=rheads,
                                               fast_gelu=fast),
                v8.vit_block_int8_static_plain(rx, r_sta, rheads, fast),
                rel=BLOCK_REL)
    for dtype, rel, mean in ((torch.bfloat16, MAX_REL, MAX_MEAN),
                             (torch.float32, 2e-5, 2e-6)):
        # separate contiguous q, k, v (phase 2 read the slices of a qkv)
        q, k, v = (torch.randn((rb, rn, rheads, 80), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        compare(f"mha_fused {str(dtype)[6:]} (3, 24, 2, 80)",
                at.mha_fused(q, k, v, 80**-0.5),
                at.mha_plain(q, k, v, 80**-0.5), rel=rel, mean=mean)
    torch.cuda.synchronize()

    # ---- 3. serve requests through full-width ViT-H, kernels on
    requests = make_requests(3, 8, SEED)
    forwards = len(requests)
    twins = {
        "vit_block_fused": lambda x, params, num_heads, fast_gelu=False:
            vb.vit_block_plain(x, params, num_heads, fast_gelu),
        "vit_block_fused_int8": lambda x, op, num_heads, fast_gelu=False:
            v8.vit_block_int8_plain(x, op, num_heads, fast_gelu),
        "vit_block_fused_int8_static":
            lambda x, op, num_heads, fast_gelu=False:
            v8.vit_block_int8_static_plain(x, op, num_heads, fast_gelu),
    }

    def twin_path():
        """Every block kernel of the model swapped for its plain twin."""
        return mock.patch.multiple(vit_mod, **twins)

    configs = {}  # name -> (cfg, model, launches per forward)
    t0 = time.time()
    cfg = serving_config("hamer_light", "bfloat16", fused_block=True)
    model = fetch_model(cfg, device=dev, seed=SEED, vit_variant=VIT)
    depth = len(model.net.backbone.blocks)
    # per block: LN1, LN2; qkv, proj, MLP1, MLP2; attention (224 for ViT-H)
    configs["bf16 fused_block (K3)"] = (cfg, model, {
        "vit_layernorm": 2 * depth, "vit_gemm": 4 * depth,
        "vit_attention": depth})
    cfg8 = serving_config("hamer_light", "bfloat16", quant_int8=True)
    require(cfg8.fused_block and cfg8.quant_int8, "quant_int8 implies fused")
    model8 = fetch_model(cfg8, device=dev, seed=SEED, vit_variant=VIT)
    # per block: 2 LN+quant, 2 row quants, 4 GEMMs, attention (288)
    configs["quant_int8 (K5)"] = (cfg8, model8, {
        "ln_quant_dynamic": 2 * depth, "quant_rows": 2 * depth,
        "gemm_i8_dynamic": 4 * depth, "qkv_attention_dynamic": depth})
    cfgs = serving_config("hamer_light", "bfloat16", quant_int8_static=True,
                          fast_gelu=True)
    require(cfgs.quant_int8 and cfgs.fused_block, "static implies int8")
    models = fetch_model(cfgs, device=dev, seed=SEED, vit_variant=VIT)
    print(f"phase 3: three HaMeR ViT-{VIT} models (depth {depth}) built in "
          f"{time.time() - t0:.1f} s")
    t0 = time.time()
    scales = cal.calibrate_scales(
        "hamer_light", models.state_dict(),
        cal.synthetic_batches(cfgs, 8, 2, device=dev), vit_variant=VIT,
        device=dev)
    inject_scales(models.net.backbone, scales)
    torch.cuda.synchronize()
    print(f"  calibrated static scales on 2 synthetic batches of 8 in "
          f"{time.time() - t0:.1f} s: " + ", ".join(
              f"{k} [{float(v.min()):.2e}, {float(v.max()):.2e}]"
              for k, v in scales.items()))
    # per block: 2 LN+quant, 4 GEMMs, attention (224)
    configs["quant_int8_static + fast_gelu (K6)"] = (cfgs, models, {
        "ln_quant_static": 2 * depth, "gemm_i8_static": 4 * depth,
        "qkv_attention_static": depth})

    served = {}
    for name, (c, m, per_forward) in configs.items():
        serve(requests[0], c, m, dev)  # warm-up; prepares int8 operands
        reset_launch_counts()
        outs = [serve(recs, c, m, dev) for recs in requests]
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches(name, counts, per_forward, forwards)
        for k in per_forward:
            rows[k]["launches"] = counts[k]
        check_outputs(outs, len(requests[0]))
        with twin_path():
            ref = serve(requests[0], c, m, dev)
        rel = SERVE_REL if "K3" in name else INT8_SERVE_REL
        for side in ("r", "l"):
            key = f"pred.mano.vertices.{side}"
            compare(f"{name[:22]} vertices.{side}", outs[0][key], ref[key],
                    rel=rel, mean=rel)
        served[name] = outs[0]
    base = served["bf16 fused_block (K3)"]["pred.mano.vertices.r"]
    for name, out in served.items():
        if "K3" not in name:
            d = (out["pred.mano.vertices.r"] - base).abs()
            print(f"  drift of {name} against the bf16 K3 path, vertices.r: "
                  f"max {float(d.max()):.3e} mean {float(d.mean()):.3e} m "
                  f"(random weights: a sanity number)")

    # K7: one ViT-H backbone forward with the fused attention, plain block
    bb = vit_mod.ViTBackbone(VIT, dtype=torch.bfloat16, fused_attn=True,
                             device=dev)
    init_weights_(bb, torch.Generator(device=dev).manual_seed(SEED))
    imgs = torch.randn((BATCH, 256, 192, 3), generator=gen, device=dev)
    with torch.inference_mode():
        bb(imgs)
        reset_launch_counts()
        feat = bb(imgs)
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches("fused_attn backbone (K7)", counts,
                       {"mha_fused": depth}, 1)
        rows["mha_fused"]["launches"] = counts["mha_fused"]
        require(feat.shape == (BATCH, 16, 12, C)
                and bool(torch.isfinite(feat).all()), "K7 backbone output")
        with mock.patch.object(vit_mod, "mha_fused", at.mha_plain):
            ref = bb(imgs)
        # 32 plain bf16 blocks with random weights amplify the bf16 flips
        # of the attention outputs; read after the last LayerNorm (features
        # of unit scale) the two paths differ by 0.10 at most and 1e-2 in
        # the mean, where a wrong kernel gives differences of order 1
        compare("fused_attn backbone vs twin", feat, ref, rel=0.25, mean=2e-2)
    del bb

    # the same paths at a small size against the CPU twins
    small_req = make_requests(1, 2, SEED + 1)[0]
    small_scales = None
    for name, (c, _, _) in configs.items():
        small_cpu = fetch_model(c, device="cpu", seed=SEED, vit_variant="tiny")
        if c.quant_int8_static:
            small_scales = cal.calibrate_scales(
                "hamer_light", small_cpu.state_dict(),
                cal.synthetic_batches(c, 2, 1, device="cpu"),
                vit_variant="tiny", device="cpu")
            inject_scales(small_cpu.net.backbone, small_scales)
        small_gpu = copy.deepcopy(small_cpu).to(dev)
        got = serve(small_req, c, small_gpu, dev)
        want = serve(small_req, c, small_cpu, "cpu")
        rel = SERVE_REL if "K3" in name else INT8_SERVE_REL
        compare(f"tiny {name[:18]} GPU vs CPU",
                got["pred.mano.vertices.r"].cpu(),
                want["pred.mano.vertices.r"], rel=rel, mean=rel)

    small_bb = vit_mod.ViTBackbone("tiny", dtype=torch.bfloat16,
                                   fused_attn=True)
    init_weights_(small_bb, torch.Generator().manual_seed(SEED))
    small_img = torch.randn((2, 256, 192, 3),
                            generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        want = small_bb(small_img)
        got = copy.deepcopy(small_bb).to(dev)(small_img.to(dev))
    compare("tiny fused_attn backbone GPU vs CPU", got.cpu(), want,
            rel=BLOCK_REL, mean=1e-2)

    # ---- 4. timing
    print(f"phase 4: CUDA-event times {tag}")
    for replaces, source, kernels in groups:
        for kname, (kfn, pfn, cases) in kernels.items():
            def each(fn):
                return [cuda_ms(lambda c=case: c.call(fn)) for case in cases]

            # plain, kernel, kernel, plain; the better of each pair of reads
            a, b, b2, a2 = each(pfn), each(kfn), each(kfn), each(pfn)
            k_ms = [min(u, v) for u, v in zip(b, b2)]
            p_ms = [min(u, v) for u, v in zip(a, a2)]
            l_ms = [None if c.library is None else
                    min(cuda_ms(c.library), cuda_ms(c.library)) for c in cases]
            for case, km, pm, lm in zip(cases, k_ms, p_ms, l_ms):
                bound = max(*case.bound(case.call(pfn)))
                lib = "none" if lm is None else f"{lm:.4f} ms"
                print(f"    {case.label:<34s} kernel {km:.4f} ms, plain "
                      f"{pm:.4f} ms, library {lib}, bound {bound:.4f} ms")
            # per block: the sum over this kernel's launch shapes
            row = rows[kname]
            row["ms"], row["plain_ms"] = sum(k_ms), sum(p_ms)
            row["library_ms"] = (None if any(v is None for v in l_ms)
                                 else sum(l_ms))
            lib = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            print(f"  {kname:<22s} per block: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, library {lib}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) {tag}")
    for case, kfn, pfn in extra:
        km = min(cuda_ms(lambda: case.call(kfn)) for _ in range(2))
        pm = min(cuda_ms(lambda: case.call(pfn)) for _ in range(2))
        lm = min(cuda_ms(case.library) for _ in range(2))
        print(f"    {case.label:<34s} kernel {km:.4f} ms, plain {pm:.4f} ms, "
              f"library {lm:.4f} ms, bound "
              f"{max(*case.bound(case.call(pfn))):.4f} ms {tag}")
    for name, (kern, twin) in blocks.items():
        t = [cuda_ms(twin), cuda_ms(kern), cuda_ms(kern), cuda_ms(twin)]
        print(f"  whole {name} (rows {ROWS}): kernels {min(t[1], t[2]):.4f} "
              f"ms, twin {min(t[0], t[3]):.4f} ms {tag}")

    # the model forward alone (preprocessed batch of 8 already on the card)
    for name, (c, m, _) in configs.items():
        pre = DevicePreprocessor(c, is_train=False, device=dev)
        inputs, _, meta = pre(stack_records(requests[0]))
        with torch.inference_mode():
            fwd = [cuda_ms(lambda: m(inputs, meta), iters=5)]
            with twin_path():
                fwd += [cuda_ms(lambda: m(inputs, meta), iters=5)
                        for _ in range(2)]
            fwd.append(cuda_ms(lambda: m(inputs, meta), iters=5))
        print(f"  {name}: model forward bs8 (16 crops): kernels "
              f"{min(fwd[0], fwd[3]):.3f} ms, twin {min(fwd[1], fwd[2]):.3f} "
              f"ms {tag}")

    def serve_rate(batches, c, m):
        def run():
            for recs in batches:
                serve(recs, c, m, dev)
            torch.cuda.synchronize()
        run()  # warm-up
        t = time.perf_counter()
        run()
        dt = time.perf_counter() - t
        n = sum(len(r) for r in batches)
        return 2 * n / dt, dt / len(batches) * 1e3  # crops/s, ms/request

    for bs, nb in ((8, 4), (64, 2)):
        batches = make_requests(nb, bs, SEED + bs)
        for name, (c, m, _) in configs.items():
            k_rate, k_ms = serve_rate(batches, c, m)
            with twin_path():
                t_rate, t_ms = serve_rate(batches, c, m)
            k_rate2, k_ms2 = serve_rate(batches, c, m)
            print(f"  {name}: serve bs{bs} ({2 * bs} crops/request): kernels "
                  f"{max(k_rate, k_rate2):.1f} crops/s "
                  f"({min(k_ms, k_ms2):.2f} ms/request), twin {t_rate:.1f} "
                  f"crops/s ({t_ms:.2f} ms/request) {tag}")

    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
