"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the fused ViT-block
CUDA kernels, holds each against its plain PyTorch twin at ViT-H shapes,
serves requests through HaMeR at full ViT-H width, and times the kernels and
the serving path with CUDA events.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and this repository;
never imports JAX. Exits non-zero on any failed phase, without a card, and
outside the repository. The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launch counts, errors and times.
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

SEED = 0
ROWS, C, HIDDEN, HEADS = 2 * 8 * 192, 1280, 5120, 16  # ViT-H at 8 images
N_TOK = 192
MAX_REL, MAX_MEAN = 3e-2, 1e-3  # bf16 kernel vs twin (sum-order flips)
# whole block: a one-ulp flip of the bf16 residual x1 at |x1| in [4, 8) is
# 2^-5 absolute, and it survives where x1 + mlp cancels to |out| < 1
BLOCK_REL = 2.0**-4
SERVE_REL = 2e-2  # vertices, kernel path vs twin path, / max(|ref|, 1)
VIT = "h"  # full ViT-H width and depth
DEV = torch.device("cuda", 0)
REPLACES = "hands_tpu/ops/vit_block_pallas.py:382"
SOURCE = "hands_tpu_torch/csrc/vit_block.cu"


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
    print(f"  {name:<28s} max|d|/max(|ref|,1) {worst:.3e} (<= {rel:g})  "
          f"mean|d| {avg:.3e} (<= {mean:g})  {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its twin")
    return float(err.max())


def block_inputs(gen, dev):
    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def f32(*shape, base=0.0):
        return base + 0.1 * torch.randn(shape, generator=gen, device=dev)

    x = randn(ROWS // N_TOK, N_TOK, C)
    p = {
        "ln1_scale": f32(C, base=1.0), "ln1_bias": f32(C),
        "wqkv": randn(3 * C, C, std=C**-0.5), "bqkv": randn(3 * C, std=0.1),
        "wproj": randn(C, C, std=C**-0.5), "bproj": randn(C, std=0.1),
        "ln2_scale": f32(C, base=1.0), "ln2_bias": f32(C),
        "w1": randn(HIDDEN, C, std=C**-0.5), "b1": randn(HIDDEN, std=0.1),
        "w2": randn(C, HIDDEN, std=HIDDEN**-0.5), "b2": randn(C, std=0.1),
    }
    return x, p


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli.demo import serve, serving_config
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.backbones import vit as vit_mod
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.ops import vit_block as vb

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = DEV
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {tag}")

    # ---- 1. build
    t0 = time.time()
    report = vb.build()
    vb._lib()
    print(f"phase 1: built {SOURCE} in {time.time() - t0:.1f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 2. each kernel against its twin at ViT-H shapes
    print(f"phase 2: kernels vs twins, rows={ROWS} C={C} hidden={HIDDEN} "
          f"heads={HEADS} D={C // HEADS}, bf16")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, p = block_inputs(gen, dev)
    x2 = x.reshape(ROWS, C)
    y = vb.layernorm_plain(x2, p["ln1_scale"], p["ln1_bias"])
    qkv = vb.gemm_plain(y, p["wqkv"], p["bqkv"])
    o = vb.attention_plain(qkv.view(-1, N_TOK, 3 * C), HEADS).view(ROWS, C)
    h = vb.gemm_plain(y, p["w1"], p["b1"], "gelu")
    cases = {
        "layernorm": [
            ("layernorm LN1", lambda f: f(x2, p["ln1_scale"], p["ln1_bias"]))],
        "gemm": [
            ("gemm qkv", lambda f: f(y, p["wqkv"], p["bqkv"])),
            ("gemm proj+residual",
             lambda f: f(o, p["wproj"], p["bproj"], "residual", x2)),
            ("gemm mlp1+gelu", lambda f: f(y, p["w1"], p["b1"], "gelu")),
            ("gemm mlp2+residual",
             lambda f: f(h, p["w2"], p["b2"], "residual", x2)),
        ],
        "attention": [
            ("attention", lambda f: f(qkv.view(-1, N_TOK, 3 * C), HEADS))],
    }
    kernel_fns = {"layernorm": (vb.layernorm, vb.layernorm_plain),
                  "gemm": (vb.gemm, vb.gemm_plain),
                  "attention": (vb.attention, vb.attention_plain)}
    max_err = {}
    for kname, items in cases.items():
        kfn, pfn = kernel_fns[kname]
        max_err[kname] = max(compare(label, call(kfn), call(pfn))
                             for label, call in items)
    torch.cuda.synchronize()
    block_err = compare("whole block",
                        vb.vit_block_fused(x, p, num_heads=HEADS),
                        vb.vit_block_plain(x, p, HEADS), rel=BLOCK_REL)
    torch.cuda.synchronize()
    print(f"  whole block max|d| {block_err:.3e}")

    # ---- 3. serve requests through full-width ViT-H, kernels on
    cfg = serving_config("hamer_light", "bfloat16", fused_block=True)
    t0 = time.time()
    model = fetch_model(cfg, device=dev, seed=SEED, vit_variant=VIT)
    depth = len(model.net.backbone.blocks)
    print(f"phase 3: HaMeR ViT-{VIT} (depth {depth}, bf16, fused_block) "
          f"built in {time.time() - t0:.1f} s")
    requests = make_requests(3, 8, SEED)
    vb.reset_launches()
    outs = [serve(recs, cfg, model, dev) for recs in requests]
    torch.cuda.synchronize()
    launches = dict(vb.launches)
    forwards = len(requests)
    print(f"  served {forwards} requests of 8 images; launches {launches}")
    # per block: LN1, LN2; qkv, proj, MLP1, MLP2; attention (224 for ViT-H)
    expected = {"layernorm": 2 * depth, "gemm": 4 * depth, "attention": depth}
    for k, per_fwd in expected.items():
        require(launches[k] == per_fwd * forwards,
                f"{k}: {launches[k]} launches, want {per_fwd} x {forwards}")
    require(sum(launches.values()) == 7 * depth * forwards, "launch total")
    for out in outs:
        for side in ("r", "l"):
            v, j = out[f"pred.mano.vertices.{side}"], \
                out[f"pred.mano.joints3d.{side}"]
            require(v.shape == (8, 778, 3) and j.shape == (8, 21, 3),
                    f"output shapes {tuple(v.shape)} {tuple(j.shape)}")
            require(bool(torch.isfinite(v).all() and torch.isfinite(j).all()),
                    "non-finite vertices or joints")
    twin = (lambda x, params, num_heads, fast_gelu=False:
            vb.vit_block_plain(x, params, num_heads))
    with mock.patch.object(vit_mod, "vit_block_fused", twin):
        ref = serve(requests[0], cfg, model, dev)
    for side in ("r", "l"):
        key = f"pred.mano.vertices.{side}"
        compare(f"served vertices .{side}", outs[0][key], ref[key],
                rel=SERVE_REL, mean=SERVE_REL)

    # the same path at a small size against the CPU twin
    small_cpu = fetch_model(cfg, device="cpu", seed=SEED, vit_variant="tiny")
    small_gpu = copy.deepcopy(small_cpu).to(dev)
    small_req = make_requests(1, 2, SEED + 1)[0]
    got = serve(small_req, cfg, small_gpu, dev)
    want = serve(small_req, cfg, small_cpu, "cpu")
    compare("tiny HaMeR GPU vs CPU twin", got["pred.mano.vertices.r"].cpu(),
            want["pred.mano.vertices.r"], rel=SERVE_REL, mean=SERVE_REL)

    # ---- 4. timing
    print(f"phase 4: CUDA-event times {tag}")
    kernel_ms, plain_ms = {}, {}
    for kname, items in cases.items():
        kfn, pfn = kernel_fns[kname]
        def each(fn):
            return [cuda_ms(lambda c=call: c(fn)) for _, call in items]

        # plain, kernel, kernel, plain; the better of each pair of reads
        a, b, b2, a2 = each(pfn), each(kfn), each(kfn), each(pfn)
        k_ms = [min(u, v) for u, v in zip(b, b2)]
        p_ms = [min(u, v) for u, v in zip(a, a2)]
        if len(items) > 1:
            for (label, _), km, pm in zip(items, k_ms, p_ms):
                print(f"    {label:<24s} kernel {km:.4f} ms, plain {pm:.4f} ms")
        # per block: the sum over this kernel's launches
        kernel_ms[kname], plain_ms[kname] = sum(k_ms), sum(p_ms)
        print(f"  {kname:<10s} per block: kernel {kernel_ms[kname]:.4f} ms, "
              f"plain {plain_ms[kname]:.4f} ms {tag}")
    blk_plain = cuda_ms(lambda: vb.vit_block_plain(x, p, HEADS))
    blk_kern = cuda_ms(lambda: vb.vit_block_fused(x, p, num_heads=HEADS))
    blk_kern2 = cuda_ms(lambda: vb.vit_block_fused(x, p, num_heads=HEADS))
    blk_plain2 = cuda_ms(lambda: vb.vit_block_plain(x, p, HEADS))
    print(f"  whole block (rows {ROWS}): kernels "
          f"{min(blk_kern, blk_kern2):.4f} ms, twin "
          f"{min(blk_plain, blk_plain2):.4f} ms {tag}")

    # the model forward alone (preprocessed batch of 8 already on the card)
    pre = DevicePreprocessor(cfg, is_train=False, device=dev)
    inputs, _, meta = pre(stack_records(requests[0]))
    with torch.inference_mode():
        fwd = [cuda_ms(lambda: model(inputs, meta), iters=5)]
        with mock.patch.object(vit_mod, "vit_block_fused", twin):
            fwd += [cuda_ms(lambda: model(inputs, meta), iters=5)
                    for _ in range(2)]
        fwd.append(cuda_ms(lambda: model(inputs, meta), iters=5))
    print(f"  model forward bs8 (16 crops): kernels {min(fwd[0], fwd[3]):.3f}"
          f" ms, twin {min(fwd[1], fwd[2]):.3f} ms {tag}")

    def serve_rate(batches):
        def run():
            for recs in batches:
                serve(recs, cfg, model, dev)
            torch.cuda.synchronize()
        run()  # warm-up
        t = time.perf_counter()
        run()
        dt = time.perf_counter() - t
        n = sum(len(r) for r in batches)
        return 2 * n / dt, dt / len(batches) * 1e3  # crops/s, ms/request

    for bs, nb in ((8, 4), (64, 2)):
        batches = make_requests(nb, bs, SEED + bs)
        k_rate, k_ms = serve_rate(batches)
        with mock.patch.object(vit_mod, "vit_block_fused", twin):
            t_rate, t_ms = serve_rate(batches)
        k_rate2, k_ms2 = serve_rate(batches)
        print(f"  serve bs{bs} ({2 * bs} crops/request): kernels "
              f"{max(k_rate, k_rate2):.1f} crops/s "
              f"({min(k_ms, k_ms2):.2f} ms/request), twin {t_rate:.1f} "
              f"crops/s ({t_ms:.2f} ms/request) {tag}")

    kernels = [{
        "name": f"vit_{k}", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches[k],
        "max_abs_err": max_err[k], "ms": kernel_ms[k],
        "plain_ms": plain_ms[k]} for k in ("layernorm", "gemm", "attention")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
