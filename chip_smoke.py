"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernels (the bf16 ViT block and its backward, the two W8A8 ViT blocks and
their knock-out variants, the fused attention, the fused skinning and its
gradient, the splat silhouette forward and backward) and the serving
kernels' C++ op registration, holds each
against its plain PyTorch twin at the shapes its path gives it, serves
requests through HaMeR at full ViT-H width and depth in its bf16,
dynamic-int8 and calibrated static-int8 configurations (and two backbone
forwards with the fused attention: bf16, and f32 on the 3xTF32 route with
TF32 off for the other products), serves and evaluates WildHands at full
width (two ResNet-50s, 224^2 crops, requests of 8 and 64 images; f32, bf16
and int8-convolution serving; the evaluation forward with the silhouette
render and the grasp classifier on, without and with gradients), holds the
trainable ViT block (the bf16 block's kernels forward; a backward that keeps
only the block's input and parameters and runs the attention, LayerNorm and
GELU backward kernels) against autograd of its twin and of the block in
f64, takes
optimiser steps with HaMeR ViT-H (64 crops a step) and with WildHands (two
ResNet-50s, 64 images a step) on synthetic batches and runs one eval step
with its metrics, runs the nine knock-out modes of the static int8 block at
256 crops through ``cli.int8_ablation`` (each mode's kernels against their
twins, its launches, the nine times and the attribution), trains, validates
and checkpoints full-width WildHands through ``cli.train`` (train-mode
preprocessing, the prefetching loader), evaluates the checkpoint through
``cli.evaluate`` and resumes the run, packs that run's records through
``cli.pack_records`` and trains an epoch on the packed set (and splits a
batch of each loader into fetch, stacking, pinning and the device half),
preprocesses, evaluates and trains WildHands with ``pos_enc="pcl"`` (the
preprocessing held against the CPU's), splits the HaMeR ViT-H and WildHands
train steps through ``cli.train_decompose``, builds miniature trees of
every real dataset family in their upstream layouts and trains full-width
WildHands on the config's default mix through ``cli.train`` (validated on
EPIC), evaluates that checkpoint and serves it through ``cli.demo --ckpt``
(bit-equal to ``restore_params`` + ``serve``), runs the 300-step learning
check (``cli.numerics_check``) and the int8 drift tool
(``cli.int8_accuracy``), exports the serving program of HaMeR (K3, K5,
K6) and WildHands through ``torch.export`` (``cli.export``), loads and runs
it beside live serving, once in a fresh process that imports only the
kernel ops, and runs ``cli.extract`` and ``cli.build_feat_split``; compiles
HaMeR K3 and WildHands into AOTInductor packages (``cli.export --aoti``,
from the build on, beside the other phases) that call the kernels' ops
registered from C++ (``csrc/torch_ops.cpp``, held bit-equal to the Python
ops), and loads and runs them in a fresh process that imports torch alone
and beside live serving and the artifact (phase 17b); builds
ARCTIC's ground truth (``process_seq``: MANO, the object, SMPL-X, 9 views)
for two 700-frame sequences on the card against the CPU and merges them
(``build_split``), holds the object templates, the objects' FK, the
interaction fields, the contact windows and every object metric against
the CPU, draws the overlays (``Trainer.visualize``, ``cli.demo`` with and
without ``--no_vis``, ``cli.sample_data``), trains data-parallel on two
ranks that share the card through gloo (HaMeR ViT-H under DDP and FSDP and
WildHands under DDP, each held against the one-process step; ``cli.train
--num_processes 2`` and a one-process ``cli.demo --ckpt`` of rank 0's
checkpoint), trains full ViT-H HaMeR on fresh synthetic draws through the
trainable block and serves the trained weights through the bf16, dynamic
int8, int8 + tanh GELU and calibrated static int8 blocks beside the
untrained weights (``cli.trained_accuracy``), sweeps 5,000 packed
EPIC-shaped records and a smaller set of records through full-width
WildHands' ``Trainer.validate`` (``cli.eval_sweep``), runs the
model-parallel axes on two ranks that share the card through gloo (HaMeR
ViT-H serving and train steps under Megatron tensor parallelism, K3 and K4
on each rank's heads with the GEMM's f32 partial-product form; the ringed
backbone and both sequence-parallel attentions; a two-stage GPipe pipeline
of K3 blocks; each held against its one-process counterpart), checks
the launch counts of each path, and times kernels, blocks, forwards,
serving, train steps and the training loop with CUDA events or the host
clock around a synchronise. An early line names the
image decoder the machine has (the native libjpeg/libpng build or cv2).

    python3 chip_smoke.py

(``python3 chip_smoke.py --dp-train-rank ...`` is one rank of the phase's
``cli.train`` run, started by the script itself.) Needs a CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin), a C++ compiler that links OpenMP (AOTInductor's) and this repository;
never imports JAX. Exits non-zero on any failed phase, without a card, and
outside the repository. The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launch count on its path, error against the twin, times (kernel,
twin, one PyTorch library call where there is one) and roofline bound.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace
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
T_START = time.time()  # the script's start, for the phases' offsets
K3 = "hands_tpu/ops/vit_block_pallas.py:382"
K5 = "hands_tpu/ops/vit_block_pallas.py:501"
K6 = "hands_tpu/ops/vit_block_pallas.py:627"
K4 = "hands_tpu/ops/vit_block_pallas.py:461"
K7 = "hands_tpu/ops/attention_pallas.py:52"
SRC_K3 = "hands_tpu_torch/csrc/vit_block.cu"
SRC_I8 = "hands_tpu_torch/csrc/vit_block_int8.cu"
SRC_ATTN = "hands_tpu_torch/csrc/attention.cu"
K1 = "hands_tpu/ops/mano_pallas.py:64"
K2 = "hands_tpu/ops/rasterizer_pallas.py:96"
SRC_LBS = "hands_tpu_torch/csrc/lbs.cu"
K8 = "scripts/vith_int8_ablation.py:178"
SRC_ABL = "hands_tpu_torch/csrc/vit_block_ablation.cu"
ABL_BATCH = 256  # crops of the ablation probe: 49,152 token rows
ABL_ITERS = 10
LOOP_STEPS = 6  # train steps an epoch of the cli.train phase
SRC_SPLAT = "hands_tpu_torch/csrc/splat.cu"
SRC_OPS = "hands_tpu_torch/csrc/torch_ops.cpp"  # the kernels' C++ ops
WH_BACKBONE = "resnet50"  # the shipped WildHands width
WH_BATCHES = ((8, 3), (64, 2))  # (images per request, requests)
WH_GRAD_BATCH = 8  # images of the forward that is differentiated
N_VERTS, RENDER_RES, RENDER_SIGMA = 778, 112, 1.5  # the 224^2 half-res render
# K2's cases beside the main path's blob and the ragged shape (batch,
# vertices, res, sigma, layout): vertices spread over the canvas and beyond
# it, 1/8 of them at +-1e4 px; sigma 12, whose cut radius (173 px) exceeds
# the canvas's diagonal, so nothing is skipped; a canvas past 128^2 pixels,
# whose backward reads the A map from device memory, not shared memory
SPLAT_CASES = ((64, N_VERTS, RENDER_RES, RENDER_SIGMA, "spread"),
               (64, N_VERTS, RENDER_RES, 12.0, "blob"),
               (2, N_VERTS, 144, 3.0, "blob"))
TRAIN_VIT_BATCH = 32  # images of a HaMeR train step: 64 crops
TRAIN_WH_BATCH = 64  # images of a WildHands train step: 128 crops + 64 images
TRAIN_STEPS = 3
TINY_TRAIN = dict(img_res=160, img_res_ds=160)  # the CPU comparison's size
# K4's backward (ops/vit_block.vit_block_backward) on the twins' pieces
# against autograd of the twin: the same computation on the same inputs, so
# only the order of a library's sums may differ from run to run; relative to
# each leaf's largest entry
K4_GRAD_REL = 1e-3
# K4's backward on its kernels against autograd of the twin: another
# computation (K3's kernels recompute the block, the backward kernels sum in
# other orders), so a leaf may move by bf16 ulps of single entries: max |d|
# and mean |d| relative to each leaf's largest entry. Both routes are also
# held to autograd of the block in f64: the kernels' mean error may be at
# most K4_F64_RATIO times the twin's
K4_GRAD_MAX, K4_GRAD_MEAN, K4_F64_RATIO = 1e-2, 1e-3, 1.5
SRC_BWD = "hands_tpu_torch/csrc/vit_block_bwd.cu"
TRAIN_ROWS = 2 * TRAIN_VIT_BATCH * N_TOK  # token rows a block of the step
# one block's launches: K4's forward; its backward (the recompute LN1, qkv,
# attention, proj, LN2, MLP1 without its GELU, then the three backward
# kernels, layernorm_bwd twice with its column-sum launch)
K4_FWD_LAUNCHES = {"vit_layernorm": 2, "vit_gemm": 4, "vit_attention": 1}
K4_BWD_LAUNCHES = {"vit_layernorm": 2, "vit_gemm": 3, "vit_attention": 1,
                   "attention_bwd": 1, "layernorm_bwd": 2,
                   "layernorm_bwd_sums": 2, "gelu_bwd": 1}
BWD_KERNELS = ("attention_bwd", "layernorm_bwd", "gelu_bwd")
# the kernels of K4's backward in the profiler's names (substrings, the
# first match counts): K3's kernels (the recompute), the backward kernels,
# the products (cuBLAS), the bias sums, the casts
K4_ACCOUNT = (("recompute", ("layernorm_kernel", "BlockEpilogue",
                             "attention_mma_kernel")),
              ("attention_bwd", ("attention_bwd_kernel",)),
              ("layernorm_bwd", ("layernorm_bwd_kernel",
                                 "column_sums_kernel")),
              ("gelu_bwd", ("gelu_bwd_kernel",)),
              ("products", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
              ("bias sums", ("reduce_kernel",)),
              ("casts", ("elementwise",)))
LBS_ABS = 1e-5  # K1 vs twin: f32 sums of 16 and 4 terms in another order
# K1 a train step: four MANO decodes (the predicted and the ground-truth
# hands; the latter under detach), the gradient of the predicted two
K1_STEP_LAUNCHES = {"lbs_apply": 4, "lbs_apply_bwd": 2}
# K1's gradient against the exact one (autograd of the twin in f64): abs +
# rel on every entry (and against the f32 twins that much plus their own
# error: each sums 778 vertices in its own order); its mean distance from
# the exact gradient at most LBS_F64_RATIO times the f32 twin's
LBS_GRAD_ABS, LBS_GRAD_REL, LBS_F64_RATIO = 1e-5, 1e-5, 1.5
# K1's shapes: hands per MANO decode of the WildHands paths (64), a large
# batch (512) and a small one (3)
LBS_BATCHES = (64, 512, 3)
MASK_ABS = 2e-5  # K2 forward vs twin (the sum over vertices runs in order)
# K2 backward vs the twin's autograd under a mean L1 mask loss. The kernel is
# also held to the twin evaluated in f64, relative to the largest entry: in
# f32 the distance |p|^2 + |v|^2 - 2 p.v cancels to ~1e-3 px^2 at coordinates
# near 112, 2e-4 of a gaussian, and both the kernel and the f32 twin carry it
GRAD_ATOL, GRAD_RTOL, GRAD_F64_REL = 1e-6, 1e-3, 2e-3
# published dense peaks of one H100 SXM: bytes/s of HBM3, operations/s by
# operand type (bf16 and int8 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_S = 3.35e12
# "sfu": results of the special-function units (exp, log, reciprocal): 16 a
# clock on each SM against 128 f32 FMAs, 1/16 of the f32 FLOP rate
# "tf32": the TF32 tensor cores (K7's f32 route counts its three TF32
# products a product)
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12,
              "sfu": 67e12 / 16}
# redesigned kernels: the design each replaced and that design's time on an
# H100 at 700 W (PERF.md), printed beside the new time and kept out of the
# kernels line, which holds this run's readings. ms per ViT-H block at 3072
# rows (the row passes' through a CUDA graph), K8's per launch at 49,152
# rows by events
ROW_BLOCK = "a 256-thread block per row"
ATTN_BEFORE, GEMM_BF16_BEFORE, GEMM_I8_BEFORE = (
    "the f32 CUDA-core attention loop", "wmma 16x16x16 + cp.async ring",
    "mma.sync m16n8k32 + cp.async ring")
F32_BEFORE = "PR 2's CUDA-core loop, a warp per query row"
EARLIER_MS = {"lbs_apply": ("a thread per (sample, vertex), A staged per "
                            "block", 0.0031),
              "splat_fwd": ("dense loop", 1.3606),
              "splat_bwd": ("dense loop", 2.4476),
              "vit_layernorm": (ROW_BLOCK, 0.0192),
              "ln_quant_dynamic": (ROW_BLOCK, 0.0294),
              "ln_quant_static": (ROW_BLOCK, 0.0239),
              "heads_split": ("a thread per 4 bytes", 0.6132),
              "ln_affine_quant": (ROW_BLOCK, 0.0893),
              "ln_cast": (ROW_BLOCK, 0.1558),
              "heads_merge_quant": ("a thread an element", 0.3444),
              "cast_rows": ("a thread an element", 0.1727),
              "qslice_quant": ("a thread an element", 0.2204),
              "attention_i8": ("dp4a, a warp per query row", 1.9415),
              "vit_attention": (ATTN_BEFORE, 0.4681),
              "qkv_attention_dynamic": (ATTN_BEFORE, 0.4360),
              "qkv_attention_static": (ATTN_BEFORE, 0.4027),
              "mha_fused": (ATTN_BEFORE, 0.4042),
              "mha_fused_f32": (F32_BEFORE, 0.7890),
              "attention_cast": (ATTN_BEFORE, 6.0831),
              "attention_no_softmax": (ATTN_BEFORE, 6.0036),
              "attention_heads": (ATTN_BEFORE, 6.2191),
              "vit_gemm": (GEMM_BF16_BEFORE, 0.7765),
              "gemm_i8_dynamic": (GEMM_I8_BEFORE, 0.6864),
              "gemm_i8_static": (GEMM_I8_BEFORE, 0.5914),
              "gemm_i8_gelu_cast": (GEMM_I8_BEFORE, 2.0725),
              "gemm_i8_ident_quant": (GEMM_I8_BEFORE, 1.8498),
              "gemm_i8_cast": (GEMM_I8_BEFORE, 1.2089)}
# every attention kernel: the bf16 ones on attention_kernel.cuh's MMA route,
# K8's int8 one and K7's f32 route
ATTENTION_KERNELS = tuple(k for k, (d, _) in EARLIER_MS.items()
                          if d == ATTN_BEFORE) + ("attention_i8",
                                                  "mha_fused_f32")
SRC_ATTN_F32 = "hands_tpu_torch/csrc/attention_f32.cuh"
# the f32 fused_attn ViT-H backbone against itself with mha_plain: the f32
# route's error is ~1e-6 of an output (3xTF32, tests/test_torch_attention_f32
# .py's emulation) against the bf16 route's flips of 2^-8, so the bf16
# backbone's 0.25 / 2e-2 over 32 blocks scale to ~1e-3 / 1e-4 here, still
# far below the order-1 differences of a wrong kernel
F32_BACKBONE_REL, F32_BACKBONE_MEAN = 1e-3, 1e-4
# the wrappers of csrc/gemm_sm90.cuh's two main loops
GEMM_KERNELS = ("vit_gemm", "gemm_i8_dynamic", "gemm_i8_static",
                "gemm_i8_gelu_cast", "gemm_i8_ident_quant", "gemm_i8_cast")
SRC_GEMM = "hands_tpu_torch/csrc/gemm_sm90.cuh"
GEMM_SERVE_BATCH = 128  # crops of a bs64 serving request: 24,576 rows
# M, N, K (bf16), K (int8) off every tile (128 x 256, K tiles of 64 bf16 or
# 128 int8): TMA's zero fill of the ragged edges and the guarded stores
RAGGED_GEMM = (200, 136, 1288, 1296)
# ragged attention shapes (batch rows, tokens, head dim), two heads: B = 1,
# token counts off the 16-row tiles, the head dims of ViT-H and of the tiny
# and b16 ViTs, and the limits (256 tokens, head dim 128, head dim 16)
ATTN_SWEEP = ((1, 50, 64), (1, 50, 80), (1, 145, 64), (1, 145, 80),
              (1, 256, 64), (1, 145, 128), (2, 24, 16))
# the int8 attention also takes a head dim that is a multiple of 4 only
ATTN_I8_SWEEP = ATTN_SWEEP + ((1, 50, 20), (2, 193, 36))
# f32 mha_fused off ATTN_SWEEP (two heads): head dims padded to 8 (20, 36),
# not a multiple of 4 (18, and 9, odd: 4-byte copies and stores), 193 keys
# (32 key tiles), and 300 keys past the tensor-core route, on the CUDA-core
# loop; with the launch count each must move
F32_RAGGED = ((1, 50, 20, "mha_fused_f32"), (2, 193, 36, "mha_fused_f32"),
              (1, 33, 18, "mha_fused_f32"), (1, 17, 9, "mha_fused_f32"),
              (1, 300, 64, "mha_fused_f32_cores"))
# LayerNorm off its rows a thread block: (rows, widths)
LN_RAGGED = ((1, 13, 3077), (128, 160, 768, 1280))
# the passes that give a row to a warp (csrc/common.cuh), graph-timed at
# every size
ROW_PASSES = ("vit_layernorm", "ln_quant_dynamic", "ln_quant_static")
# ln_quant's rows whose mean is large against their spread: the fast variance
# E[x^2] - E[x]^2 cancels, so the kernel's sum order (lane partials, then a
# butterfly) and the twin's part most there. Means in units of the spread (6):
# 16 for the static form (E[x^2] is 257 times the variance); 1 for the
# dynamic one, whose row scale carries half the variance's relative error
# and is held to 1e-6 (at 16 the two orders' scales part by 3e-5 to 8e-5:
# tests/test_torch_rowpass.py's emulation)
LNQ_CANCEL_MEAN = {False: 16.0, True: 1.0}
# heads_split and heads_merge_quant off the 256-crop shape: (B, N, H, D); D 6
# takes the 4-byte form
SPLIT_RAGGED = ((1, 13, 3, 80), (1, 13, 3, 6), (1, 13, 3, 64))
# K8's cast_rows off the 256-crop shape: value counts (13 x 1283 as a 2-D
# tensor), each also from x 2 and 4 bytes past a 16-byte boundary
CAST_RAGGED = (1, 7, 9, (13, 1283), (ABL_BATCH * N_TOK, C))
# the bare cast's edges in bf16: NaN, infinities, signed zeros, at and past
# the int8 range, huge values, subnormals (2^-133 is bf16's least)
CAST_EDGES = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 127.5,
              -127.5, 128.0, -128.0, 129.0, -129.0, 1e30, -1e30, 2.0**-133,
              -(2.0**-133), 2.0**-127)
# K8's qslice_quant off the 256-crop shape: (token rows, qkv widths C3 and
# the form each takes); C = C3 // 3 is 8, 128, 1280 (16-byte form), 1284,
# 130 (4-byte form) or 3 (a value a step); 392 and 385 are no 3C
QSLICE_RAGGED = ((1, 13, 192), {24: 16, 384: 16, 3840: 16, 3852: 4, 390: 4,
                                 9: 2, 392: 4, 385: 2})
# the kernels of K8's launches in the profiler's names (substrings): the
# LayerNorm passes, the GEMMs by epilogue (int8 static: 4 qkv, 5 the two
# residual ones, 6 GELU; AblationEpilogue: the knocked-out ones), the
# attention, the head relayouts
K8_KERNEL_NAMES = ("ln_quant_kernel", "ln_ablation_kernel", "Epilogue<4",
                   "Epilogue<5", "Epilogue<6", "AblationEpilogue",
                   "attention_mma_kernel", "heads_split_kernel",
                   "heads_merge_quant_kernel", "cast_rows_kernel",
                   "qslice_quant_kernel")
# the modes whose difference from full is accounted launch by launch
K8_ACCOUNTED = ("no_ln", "no_quant", "attn_merged", "no_attn", "mm_only")
# K8's modes made of bare casts, timed also on inputs that fill the int8
# range (ablation_alone(wide=True)), beside full
K8_WIDE_MODES = ("full", "no_quant", "mm_only")


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


def host_ms(fn, iters: int = 100) -> float:
    """Mean host time of a call of ``fn`` (the enqueue, not the kernel)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - start) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def graph_ms(fn, iters: int = 50, replays: int = 20) -> float:
    """Mean device time of ``fn`` for launches of a few microseconds:
    ``iters`` calls captured into one CUDA graph and replayed, so that the
    host's per-launch cost does not hide the device's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=replays) / iters


def short_ms(fn) -> float:
    """:func:`graph_ms` for launches of a few tens of microseconds whose
    outputs are large (10 calls a graph)."""
    return graph_ms(fn, iters=10)


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


def compare_abs(name, got, ref, atol, rtol=0.0) -> float:
    """|got - ref| <= atol + rtol |ref| on every element."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    excess = float((err - rtol * r.abs()).max())
    ok = bool(torch.isfinite(g).all()) and excess <= atol
    print(f"  {name:<34s} max|d| {float(err.max()):.3e}, max(|d| - {rtol:g}"
          f"|ref|) {excess:.3e} (<= {atol:g})  max|ref| "
          f"{float(r.abs().max()):.3e}  {'ok' if ok else 'FAIL'}")
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
    status = "FAIL" if not ok else "bit-equal" if worst == 0 else "ok"
    print(f"  {name:<34s} max step {worst} (<= {INT8_MAX_STEP})  share moved "
          f"{share:.3e} (<= {INT8_MAX_SHARE:g})  {status}")
    require(ok, f"{name}: kernel disagrees with its twin")
    return float(worst)


def compare_equal(name, got, ref) -> float:
    """Every bit agrees: an int8 GEMM on the same int8 inputs (int32 sums
    are exact and the f32 epilogue is evaluated op by op on both sides), a
    relayout, a row pass that sums in its twin's order."""
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs().float()
    else:
        d = (got.float() - ref.float()).abs()
    worst, moved = float(d.max()), int((d > 0).sum())
    print(f"  {name:<34s} max|d| {worst:.3e}, {moved} of {d.numel()} differ  "
          f"{'bit-equal' if moved == 0 else 'FAIL'}")
    require(moved == 0, f"{name}: not bit-equal to its twin")
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


def compare_grad(name, got, ref, rel_max=K4_GRAD_MAX,
                 rel_mean=K4_GRAD_MEAN) -> float:
    """Gradients: max |d| and mean |d| relative to the reference's largest
    entry (a gradient's entries span decades; an absolute bound per entry
    says nothing)."""
    g, r = got.float(), ref.float()
    scale = float(r.abs().max())
    err = (g - r).abs()
    worst, avg = float(err.max()) / scale, float(err.mean()) / scale
    ok = (bool(torch.isfinite(g).all()) and scale > 0 and worst <= rel_max
          and avg <= rel_mean)
    print(f"  {name:<34s} max|d|/max|ref| {worst:.3e} (<= {rel_max:g})  "
          f"mean {avg:.3e} (<= {rel_mean:g})  {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its twin")
    return float(err.max())


def compare_dqkv(name, got, ref) -> float:
    """The attention backward's dq, dk and dv, each against its own scale."""
    c = got.shape[-1] // 3
    return max(compare_grad(f"{name} {part}", got[..., i * c:(i + 1) * c],
                            ref[..., i * c:(i + 1) * c])
               for i, part in enumerate(("dq", "dk", "dv")))


def compare_ln_bwd(name, got, ref) -> float:
    """(dx bf16, dscale, dbias f32): dx as a gradient; the column sums of
    3072 to 12,288 f32 terms in another order than PyTorch's, to 1e-4 of
    the largest."""
    return max(compare_grad(f"{name} dx", got[0], ref[0]),
               compare_grad(f"{name} dscale", got[1], ref[1], 1e-4, 1e-5),
               compare_grad(f"{name} dbias", got[2], ref[2], 1e-4, 1e-5))


def bf16_ulps(got, ref) -> torch.Tensor:
    """|got - ref| in bf16 units in the last place, per entry (the order of
    the bit patterns; +0 and -0 are 0 apart)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(got) - ordered(ref)).abs()


def compare_ulps(name, got, ref) -> float:
    """bf16 outputs of an elementwise chain (``gelu_bwd``: du, h): bit-equal
    to the twin unless the card's ``expf`` / ``erfcf`` / ``tanhf`` builds
    differ in the last place; then at most one bf16 ulp, the entries apart
    counted."""
    worst = 0.0
    for part, a, b in zip(("du", "h"), got, ref):
        d = bf16_ulps(a, b)
        moved, top = int((d > 0).sum()), int(d.max())
        ok = top <= 1 and bool(torch.isfinite(a.float()).all())
        print(f"  {name + ' ' + part:<34s} {moved} of {d.numel()} entries "
              f"apart, max {top} ulp (<= 1)  "
              f"{'bit-equal' if moved == 0 else 'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {part}: kernel disagrees with its twin")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return worst


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Case:
    """One launch shape of a kernel: how to call the wrapper or the twin
    (``call(fn)``), the library call (the same function), a yardstick
    (``(label, fn)``: a PyTorch call that moves the same bytes but computes
    another function, printed and kept out of the kernels line), the path
    the kernel replaced (``(label, fn)``, printed beside it), the bytes the
    function must move (each input once, each output once) and the
    operations it does."""

    def __init__(self, label, call, inputs, ops, kind, library=None,
                 check=compare, timer=cuda_ms, saved_bytes=0, dense_ops=None,
                 yardstick=None, replaced=None):
        self.label, self.call, self.library = label, call, library
        self.yardstick, self.replaced = yardstick, replaced
        self.inputs, self.ops, self.kind, self.check = inputs, ops, kind, check
        # where the work depends on the data, ``ops`` counts what these
        # inputs need and ``dense_ops`` what a dense evaluation does
        self.dense_ops = dense_ops
        self.timer = timer  # graph_ms for launches of a few microseconds
        self.saved_bytes = saved_bytes  # written for a backward, not returned

    def bound(self, out) -> tuple:
        outs = out if isinstance(out, tuple) else (out,)
        t_bytes = (nbytes(*self.inputs) + nbytes(*outs)
                   + self.saved_bytes) / HBM_BYTES_S * 1e3
        t_ops = self.ops / PEAK_OPS_S[self.kind] * 1e3
        return t_bytes, t_ops

    def dense_bound(self, out) -> str:
        """The bound of a dense evaluation, printed beside the data's own."""
        if self.dense_ops is None:
            return ""
        t_bytes, _ = self.bound(out)
        t_ops = self.dense_ops / PEAK_OPS_S[self.kind] * 1e3
        return (f", dense bound {max(t_bytes, t_ops):.4f} ms "
                f"({self.ops / self.dense_ops:.2%} of the pairs)")


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


def k3_cases(x, p, heads):
    """K3's kernels (the bf16 block's LayerNorm, four GEMMs and attention)
    at the launch shapes of one block on ``x`` (B, N, C) with ``heads``
    heads, in the format of :func:`kernel_cases`' dicts; the tanh-GELU
    epilogue as an extra case; and the plain block's intermediates (``y``,
    ``qkv``, ``o``, ``h``) with the shape's operation counts and SDPA call,
    which the other blocks' cases reuse."""
    from hands_tpu_torch.ops import vit_block as vb

    bf = torch.bfloat16
    batch, n_tok, c = x.shape
    hidden = p["w1"].shape[0]
    rows = batch * n_tok
    x2 = x.reshape(rows, c)
    attn_ops = 4 * batch * heads * n_tok * n_tok * (c // heads)
    ln_ops = 8 * rows * c

    def gemm_ops(n, k):
        return 2 * rows * n * k

    def sdpa(qkv3):
        t = qkv3.view(batch, n_tok, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4)
        return lambda: F.scaled_dot_product_attention(t[0], t[1], t[2])

    y = vb.layernorm_plain(x2, p["ln1_scale"], p["ln1_bias"])
    qkv = vb.gemm_plain(y, p["wqkv"], p["bqkv"])
    qkv3 = qkv.view(batch, n_tok, 3 * c)
    o = vb.attention_plain(qkv3, heads).view(rows, c)
    h = vb.gemm_plain(y, p["w1"], p["b1"], "gelu")
    ln_w, ln_b = p["ln1_scale"].to(bf), p["ln1_bias"].to(bf)
    k3 = {
        "vit_layernorm": (vb.layernorm, vb.layernorm_plain, [
            Case("layernorm LN1",
                 lambda f: f(x2, p["ln1_scale"], p["ln1_bias"]),
                 [x2, p["ln1_scale"], p["ln1_bias"]], ln_ops, "f32",
                 lambda: F.layer_norm(x2, (c,), ln_w, ln_b, 1e-6)),
            Case("layernorm LN2",
                 lambda f: f(o, p["ln2_scale"], p["ln2_bias"]),
                 [o, p["ln2_scale"], p["ln2_bias"]], ln_ops, "f32",
                 lambda: F.layer_norm(o, (c,), ln_w, ln_b, 1e-6))]),
        "vit_gemm": (vb.gemm, vb.gemm_plain, [
            Case("gemm qkv", lambda f: f(y, p["wqkv"], p["bqkv"]),
                 [y, p["wqkv"], p["bqkv"]], gemm_ops(3 * c, c), "bf16",
                 lambda: F.linear(y, p["wqkv"], p["bqkv"])),
            Case("gemm proj+residual",
                 lambda f: f(o, p["wproj"], p["bproj"], "residual", x2),
                 [o, p["wproj"], p["bproj"], x2], gemm_ops(c, c), "bf16",
                 lambda: F.linear(o, p["wproj"], p["bproj"])),
            Case("gemm mlp1+gelu",
                 lambda f: f(y, p["w1"], p["b1"], "gelu"),
                 [y, p["w1"], p["b1"]], gemm_ops(hidden, c), "bf16",
                 lambda: F.linear(y, p["w1"], p["b1"])),
            Case("gemm mlp2+residual",
                 lambda f: f(h, p["w2"], p["b2"], "residual", x2),
                 [h, p["w2"], p["b2"], x2], gemm_ops(c, hidden), "bf16",
                 lambda: F.linear(h, p["w2"], p["b2"])),
        ]),
        "vit_attention": (vb.attention, vb.attention_plain, [
            Case("attention", lambda f: f(qkv3, heads), [qkv3], attn_ops,
                 "bf16", sdpa(qkv3))]),
    }
    # the tanh-GELU epilogue: checked against its twin, timed with the block
    # shapes outside a row's per-block sum: (case, wrapper, twin)
    extra = [(Case("gemm mlp1+gelu_tanh",
                   lambda f: f(y, p["w1"], p["b1"], "gelu_tanh"),
                   [y, p["w1"], p["b1"]], gemm_ops(hidden, c), "bf16",
                   lambda: F.linear(y, p["w1"], p["b1"])),
              vb.gemm, vb.gemm_plain)]
    plain = SimpleNamespace(y=y, qkv=qkv, o=o, h=h, attn_ops=attn_ops,
                            ln_ops=ln_ops, gemm_ops=gemm_ops, sdpa=sdpa)
    return k3, extra, plain


def kernel_cases(x, p, p32):
    """Every kernel of the port with its launch shapes at ViT-H width for the
    crops of ``x`` (B, 192, 1280): {kernel name: (wrapper, twin, route info,
    [Case, ...])}."""
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import quant
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8

    bf = torch.bfloat16
    batch = x.shape[0]
    rows = batch * N_TOK
    x2 = x.reshape(rows, C)
    x32 = x2.float()

    # ---- K3: bf16 block
    k3, extra, t = k3_cases(x, p, HEADS)
    y, qkv, o, h = t.y, t.qkv, t.o, t.h
    attn_ops, ln_ops, gemm_ops, sdpa = t.attn_ops, t.ln_ops, t.gemm_ops, t.sdpa

    # ---- K5: dynamic W8A8 block
    d = quant.prepare_int8(p32)
    qy, sy = v8.ln_quant_plain(x2, d["ln1_s"], d["ln1_b"], True)
    dqkv = v8.gemm_i8_plain(qy, d["wqkv_q"], d["sqkv"], d["bqkv"],
                            row_scale=sy)
    dqkv3 = dqkv.view(batch, N_TOK, 3 * C)
    do = at.qkv_attention_plain(dqkv3, HEADS).view(rows, C)
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
                 3 * rows * C, "f32", check=compare_int8),
            Case("quant_rows GELU out (f32)", lambda f: f(hm), [hm],
                 3 * rows * HIDDEN, "f32", check=compare_int8)]),
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
    sqkv3 = sqkv.view(batch, N_TOK, 3 * C)
    sqo = at.qkv_attention_plain(sqkv3, HEADS, s["inv_proj"]).view(rows, C)
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

    # ---- K7: fused attention on the slices of a fused qkv, bf16 and f32;
    # the f32 qkv of an f32 projection (f32 values, not bf16 ones widened)
    q5 = qkv.view(batch, N_TOK, 3, HEADS, HEAD_DIM)
    q5f = F.linear(x32, p32["wqkv"], p32["bqkv"]).view(
        batch, N_TOK, 3, HEADS, HEAD_DIM)
    scale = HEAD_DIM**-0.5

    def mha(t5):
        return lambda f: f(t5[:, :, 0], t5[:, :, 1], t5[:, :, 2], scale)

    def sdpa5(t5):
        t = t5.permute(2, 0, 3, 1, 4)
        return lambda: F.scaled_dot_product_attention(t[0], t[1], t[2])

    # bf16 is the serving backbone's path; f32 the JAX test's type and the
    # f32 backbone's (2e-5 / 2e-6), three TF32 products a product, beside
    # the CUDA-core loop it replaced
    k7 = {
        "mha_fused": (at.mha_fused, at.mha_plain, [
            Case("mha_fused bf16", mha(q5), [q5], attn_ops, "bf16",
                 sdpa5(q5))]),
        "mha_fused_f32": (at.mha_fused, at.mha_plain, [
            Case("mha_fused f32 (3xTF32)", mha(q5f), [q5f], 3 * attn_ops,
                 "tf32", sdpa5(q5f),
                 lambda n, g, r: compare(n, g, r, rel=2e-5, mean=2e-6),
                 replaced=(F32_BEFORE, lambda: mha(q5f)(at.mha_f32_cores)))]),
    }
    groups = [(K3, SRC_K3, k3), (K5, SRC_I8, k5), (K6, SRC_I8, k6),
              (K7, SRC_ATTN, k7)]
    # at 3072 rows a launch takes 5-90 us on the card and its wrapper 20-45
    # us on the host: time every case, its twin and its library call through
    # a CUDA graph, so that the host's cost is not read as the card's (10
    # calls a graph: outputs stay in the graph's pool)
    # (the row passes at every size: 0.01-0.1 ms a launch)
    for case in [c for _, _, ks in groups for k, (*_, cs) in ks.items()
                 for c in cs if rows <= ROWS or k in ROW_PASSES] + [
                     e[0] for e in extra if rows <= ROWS]:
        case.timer = short_ms
    # the int8 blocks' attention lives in the attention library
    sources = {"qkv_attention_dynamic": SRC_ATTN,
               "qkv_attention_static": SRC_ATTN,
               "mha_fused_f32": SRC_ATTN_F32}
    operands = {"dynamic": d, "static": s}
    return groups, sources, extra, operands


def bwd_cases(x, p, gen):
    """K4's backward kernels (``csrc/vit_block_bwd.cu``) at the shapes one
    block's backward gives them for the crops of ``x`` (B, 192, 1280), on
    the block's own activations (the twin's forward) and random gradients:
    groups in the format of :func:`kernel_cases`, and the tanh GELU's
    backward as an extra case."""
    from hands_tpu_torch.ops import vit_block as vb

    bf = torch.bfloat16
    batch = x.shape[0]
    rows = batch * N_TOK
    x2 = x.reshape(rows, C)

    def grad(*shape):
        return (0.1 * torch.randn(shape, generator=gen,
                                  device=x.device)).to(bf)

    y1 = vb.layernorm_plain(x2, p["ln1_scale"], p["ln1_bias"])
    qkv3 = vb.gemm_plain(y1, p["wqkv"], p["bqkv"]).view(batch, N_TOK, 3 * C)
    o = vb.attention_plain(qkv3, HEADS).view(rows, C)
    x1 = vb.gemm_plain(o, p["wproj"], p["bproj"], "residual", x2)
    u = vb.gemm_plain(vb.layernorm_plain(x1, p["ln2_scale"], p["ln2_bias"]),
                      p["w1"], p["b1"])
    g2, dy2, dx1, dy1 = (grad(rows, C) for _ in range(4))
    dh, do = grad(rows, HIDDEN), grad(batch, N_TOK, C)
    # the minimum work: the products s, dp, dq, dk, dv of every head
    attn_ops = 10 * batch * HEADS * N_TOK * N_TOK * HEAD_DIM
    ln_ops = 20 * rows * C

    def flash_bwd():
        sc = vb.bf16_const(HEAD_DIM**-0.5)
        t = qkv3.view(batch, N_TOK, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4)
        out, lse, cq, ck, mq, mk, seed, off = (
            torch.ops.aten._scaled_dot_product_flash_attention(
                t[0], t[1], t[2], 0.0, False, False, scale=sc)[:8])
        go = do.view(batch, N_TOK, HEADS, HEAD_DIM).transpose(1, 2)
        return lambda: (
            torch.ops.aten._scaled_dot_product_flash_attention_backward(
                go, t[0], t[1], t[2], out, lse, cq, ck, mq, mk, 0.0, False,
                seed, off, scale=sc))

    def ln_bwd(xin, scale, dy):
        w = scale.to(bf)
        b = torch.zeros_like(w)
        _, mean, rstd = torch.ops.aten.native_layer_norm(xin, (C,), w, b,
                                                        1e-6)
        return lambda: torch.ops.aten.native_layer_norm_backward(
            dy, xin, (C,), mean, rstd, w, b, (True, True, True))

    def gelu_case(fast):
        return Case(f"gelu backward ({'tanh' if fast else 'erf'})",
                    lambda f: f(u, dh, fast), [u, dh],
                    (1 if fast else 2) * rows * HIDDEN, "sfu",
                    lambda: torch.ops.aten.gelu_backward(
                        dh, u, approximate="tanh" if fast else "none"),
                    compare_ulps)

    kernels = {
        "attention_bwd": (vb.attention_bwd, vb.attention_bwd_plain, [
            Case("attention backward", lambda f: f(qkv3, do, HEADS),
                 [qkv3, do], attn_ops, "bf16", flash_bwd(), compare_dqkv)]),
        "layernorm_bwd": (vb.layernorm_bwd, vb.layernorm_bwd_plain, [
            Case("layernorm backward LN2",
                 lambda f: f(x1, dy2, p["ln2_scale"], g2),
                 [x1, dy2, p["ln2_scale"], g2], ln_ops, "f32",
                 ln_bwd(x1, p["ln2_scale"], dy2), compare_ln_bwd),
            Case("layernorm backward LN1",
                 lambda f: f(x2, dy1, p["ln1_scale"], dx1),
                 [x2, dy1, p["ln1_scale"], dx1], ln_ops, "f32",
                 ln_bwd(x2, p["ln1_scale"], dy1), compare_ln_bwd)]),
        "gelu_bwd": (vb.gelu_bwd, vb.gelu_bwd_plain, [gelu_case(False)]),
    }
    # every launch through a CUDA graph: the wrappers' host time (two
    # launches and three allocations for layernorm_bwd) is as long as a
    # launch at 3072 rows
    cases = [c for _, _, cs in kernels.values() for c in cs]
    extra = [(gelu_case(True), vb.gelu_bwd, vb.gelu_bwd_plain)]
    for case in cases + [extra[0][0]]:
        case.timer = short_ms
    return [(K4, SRC_BWD, kernels)], extra


def skinning_inputs(gen, dev, batch):
    """Posed-template vertices and skinning transforms of ``batch`` hands:
    small rotations and translations, as the heads emit them."""
    from hands_tpu_torch.core import rot as rotlib

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    v_posed = randn(batch, N_VERTS, 3, std=0.1)
    A = torch.zeros((batch, 16, 4, 4), device=dev)
    A[:, :, :3, :3] = rotlib.axis_angle_to_matrix(randn(batch, 16, 3, std=0.3))
    A[:, :, :3, 3] = randn(batch, 16, 3, std=0.05)
    A[:, :, 3, 3] = 1.0
    return v_posed, A


def projected_vertices(gen, dev, batch, n_verts, res, layout="blob"):
    """Projected vertices of ``batch`` hands in render pixels. ``blob``: a
    blob of 0.08 res around a centre inside the image; ``spread``: uniform
    over [-res / 2, 3 res / 2]^2, every eighth vertex at +-1e4 px."""
    if layout == "spread":
        v = (torch.rand((batch, n_verts, 2), generator=gen, device=dev) * 2.0
             - 0.5) * res
        far = v[:, ::8]
        sign = torch.randint(0, 2, far.shape, generator=gen, device=dev)
        v[:, ::8] = (2.0 * sign - 1.0) * 1e4
        return v.contiguous()
    centre = (0.25 + 0.5 * torch.rand((batch, 1, 2), generator=gen,
                                      device=dev)) * res
    return (centre + torch.randn((batch, n_verts, 2), generator=gen,
                                 device=dev) * (0.08 * res)).contiguous()


def splat_nonzero_pairs(v2d, res, sigma) -> int:
    """The pixel-vertex pairs whose gaussian is nonzero in the twin's f32
    evaluation: the work the splat needs on these inputs."""
    from hands_tpu_torch.ops import rasterizer as ras

    chunk = max(1, (1 << 27) // (res * res * v2d.shape[1]))
    return sum(int((ras.splat_gaussians(v2d[i:i + chunk], res, sigma) > 0)
                   .sum()) for i in range(0, v2d.shape[0], chunk))


def splat_in_order(v2d, res, sigma):
    """The forward's (lm, mask) in plain PyTorch, every step as the kernel
    rounds it: the distance as ``(|p|^2 + |v|^2) - 2 fma(p_y, v_y, p_x v_x)``,
    a true f32 division, and the sum over vertices in vertex order."""
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops.quant import fma_f32

    B, V, _ = v2d.shape
    pix = ras._pixel_grid(res, device=v2d.device)
    px, py = pix[None, :, 0], pix[None, :, 1]
    p_sq = px * px + py * py
    two_s2 = torch.tensor(float(ras.two_sigma_sq(sigma)), device=v2d.device)
    clip = torch.tensor(1.0 - 1e-6, dtype=torch.float32)
    lm = torch.zeros((B, res * res), device=v2d.device)
    for i in range(V):
        vx, vy = v2d[:, i, 0:1], v2d[:, i, 1:2]
        cross = fma_f32(py, vy.expand_as(lm), px * vx)
        d2 = torch.clamp((p_sq + (vx * vx + vy * vy)) - 2.0 * cross, min=0.0)
        g = torch.clamp(torch.exp(torch.div(-d2, two_s2)), max=float(clip))
        lm = lm + torch.log1p(-g)
    return lm, 1.0 - torch.exp(lm)


def splat_exactness(v2d, res, sigma) -> None:
    """What the skipping rests on, read on the card: exp of every f32 from
    ``EXP_ZERO`` down to 8 below it (and of far values) is 0, of the next f32
    above it not; and whether the forward kernel is bit-equal to
    :func:`splat_in_order` on ``v2d``."""
    from hands_tpu_torch.ops import rasterizer as ras

    x0 = torch.tensor([ras.EXP_ZERO], dtype=torch.float32)
    bits = int(x0.view(torch.int32))  # negative: larger bits, lower value
    n = 8 << 17  # the f32 spacing at 104 is 2^-17
    xs = (torch.arange(bits, bits + n, dtype=torch.int64, device=DEV)
          .to(torch.int32).view(torch.float32))
    far = torch.tensor([-110.0, -1e4, -1e30, -float("inf")], device=DEV)
    above = torch.tensor([bits - 1], dtype=torch.int32).view(torch.float32)
    zero = bool((torch.exp(torch.cat([xs, far])) == 0).all())
    up = float(torch.exp(above.to(DEV)))
    print(f"  exp on the card: 0 from {float(x0):.9g} down to "
          f"{float(xs[-1]):.9g} and at -110, -1e4, -1e30, -inf: {zero}; at "
          f"the next f32 above, {float(above):.9g}: {up:.3e}")
    require(zero and up > 0.0, "exp on the card does not vanish at EXP_ZERO")
    got = ras._launch_fwd(v2d, res, sigma)
    moved = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
             for a, b in zip(got, splat_in_order(v2d, res, sigma))]
    lm = got[0]
    print(f"  splat forward B={v2d.shape[0]} res={res} V={v2d.shape[1]} "
          f"against the in-order plain sum: {moved[0]} of {lm.numel()} lm "
          f"and {moved[1]} mask values differ"
          + ("  bit-equal" if not any(moved) else ""))


class SplatGrad:
    """The gradient of the splat under a fixed upstream ``gmask``. The twin's
    (and any other function's) by autograd of a forward graph built once, so
    that a timed call is the backward alone; the kernel's by the backward
    kernel on the forward kernel's log-miss map, without the autograd
    engine, whose host time is as long as a launch of ~0.2 ms. (The f64
    check of :func:`geometry_cases` takes the kernels through autograd.)"""

    def __init__(self, v2d, res, sigma, gmask):
        self.v2d, self.res, self.sigma, self.gmask = v2d, res, sigma, gmask
        self._graphs = {}
        self._lm = None

    def __call__(self, fn):
        from hands_tpu_torch.ops import rasterizer as ras

        if fn is ras.splat_silhouette_fused:
            if self._lm is None:
                self._lm = ras._launch_fwd(self.v2d, self.res, self.sigma)[0]
            return ras._launch_bwd(self.v2d, self._lm,
                                   self.gmask.reshape(self._lm.shape),
                                   self.res, self.sigma)
        if fn not in self._graphs:
            v = self.v2d.detach().clone().requires_grad_(True)
            self._graphs[fn] = (v, fn(v, self.res, self.sigma))
        v, mask = self._graphs[fn]
        return torch.autograd.grad(mask, v, self.gmask, retain_graph=True)[0]

    def release(self):
        self._graphs.clear()
        self._lm = None


def lbs_weights(dev):
    from hands_tpu_torch.ops import mano as manolib

    return manolib.load_mano(True, device=dev).lbs_weights


def lbs_bwd_replaced(v_posed, W, A, g):
    """K1's backward as it ran before its kernel: autograd of the twin,
    recomputed from the saved inputs."""
    from hands_tpu_torch.ops import mano_lbs as ml

    with torch.enable_grad():
        v, a = (t.detach().requires_grad_(True) for t in (v_posed, A))
        return torch.autograd.grad(ml.lbs_apply_plain(v, W, a), (v, a), g)


def lbs_grad_check(v_posed, W, A, g):
    """The check of K1's backward on these inputs. ``got`` (the kernel's
    (dv, dA)) within 1e-5 abs + 1e-5 rel of the exact gradient (autograd of
    the twin in f64) on every entry; within that plus the f32 twin's own
    distance from the exact one of autograd of the twin in f32 and of the
    plain backward (``ref``): each sums the 778 vertices of an entry of dA
    in its own order, and the f32 twins themselves miss 1e-5 of the exact
    value on some entries; its mean distance from the exact gradient at
    most 1.5x the f32 twin's; a second run bit-equal."""
    from hands_tpu_torch.ops import mano_lbs as ml

    def check(name, got, ref):
        twin = lbs_bwd_replaced(v_posed, W, A, g)
        exact = lbs_bwd_replaced(*(t.double() for t in (v_posed, W, A, g)))
        again = ml.lbs_apply_bwd(v_posed, W, A, g)
        worst = 0.0
        for part, k, p, t, x, k2 in zip(("d v_posed", "d A"), got, ref, twin,
                                        exact, again):
            compare_abs(f"{name} {part} vs exact", k, x, LBS_GRAD_ABS,
                        LBS_GRAD_REL)
            for label, t32 in (("autograd of the twin", t), ("plain", p)):
                d = (k.double() - t32).abs()
                bare = LBS_GRAD_ABS + LBS_GRAD_REL * t32.double().abs()
                own = (t32 - x).abs()
                ok = bool((d <= bare + own).all())
                print(f"  {name} {part} vs {label}: max|d| {float(d.max()):.3e};"
                      f" {int((d > bare).sum())} entries past 1e-5 + 1e-5|ref|"
                      f" (the f32 {label} itself misses the exact value by "
                      f"that much on {int((own > bare).sum())}), none past it "
                      f"plus the f32 one's own error: {'ok' if ok else 'FAIL'}")
                require(ok, f"{name} {part}: kernel disagrees with {label}")
            worst = max(worst, float((k - t).abs().max()))
            dk, dt = ((y.double() - x).abs() for y in (k, t))
            ratio = float(dk.mean()) / max(float(dt.mean()), 1e-300)
            print(f"  {name} {part} vs exact: mean|d| {float(dk.mean()):.3e}"
                  f" (f32 twin {float(dt.mean()):.3e}, {ratio:.2f}x <= "
                  f"{LBS_F64_RATIO:g}x), max|d| {float(dk.max()):.3e} (f32 "
                  f"twin {float(dt.max()):.3e})")
            require(ratio <= LBS_F64_RATIO,
                    f"{name} {part}: farther from the f64 twin than the f32 "
                    f"twin is")
            require(torch.equal(k, k2), f"{name} {part}: two runs differ")
        print(f"  {name}: two runs bit-equal")
        return worst
    return check


def lbs_cases(gen, dev):
    """K1's forward and backward at :data:`LBS_BATCHES`, in the format of
    :func:`kernel_cases`: (the group at 64 hands, the extra shapes)."""
    from hands_tpu_torch.ops import mano_lbs as ml

    W = lbs_weights(dev)

    def cases(b):
        v_posed, A = skinning_inputs(gen, dev, b)
        g = torch.randn(v_posed.shape, generator=gen, device=dev)
        fwd = Case(
            f"lbs_apply B={b}", lambda f: f(v_posed, W, A), [v_posed, W, A],
            b * N_VERTS * (2 * 16 * 12 + 2 * 9), "f32",
            lambda: ml.lbs_apply_plain(v_posed, W, A),
            lambda n, got, r: compare_abs(n, got, r, LBS_ABS),
            timer=graph_ms)
        # the blend's 3x3 part and its transpose applied; the products
        # g_r vh_c and the sum of the 192 entries of dA over the vertices
        bwd = Case(
            f"lbs_apply_bwd B={b}", lambda f: f(v_posed, W, A, g),
            [v_posed, W, A, g],
            b * N_VERTS * (2 * 16 * 9 + 2 * 9 + 12 + 2 * 16 * 12), "f32",
            None, lbs_grad_check(v_posed, W, A, g), timer=graph_ms,
            replaced=("autograd of the twin",
                      lambda: lbs_bwd_replaced(v_posed, W, A, g)))
        return fwd, bwd

    fwd, bwd = cases(LBS_BATCHES[0])
    group = (K1, SRC_LBS, {
        "lbs_apply": (ml.lbs_apply, ml.lbs_apply_plain, [fwd]),
        "lbs_apply_bwd": (ml.lbs_apply_bwd, ml.lbs_apply_bwd_plain, [bwd])})
    extra = []
    for b in LBS_BATCHES[1:]:
        fwd, bwd = cases(b)
        extra += [(fwd, ml.lbs_apply, ml.lbs_apply_plain),
                  (bwd, ml.lbs_apply_bwd, ml.lbs_apply_bwd_plain)]
    return group, extra


def geometry_cases(gen, dev, batch):
    """K1 and K2 at the shapes the WildHands paths give them (``batch``
    hands per MANO decode and per render), in the format of
    :func:`kernel_cases`; plus the shapes that are no multiple of any tile.
    Returns (groups, extra, the SplatGrad objects to release)."""
    from hands_tpu_torch.ops import mano_lbs as ml
    from hands_tpu_torch.ops import rasterizer as ras

    require(batch == LBS_BATCHES[0], "K1's main shape is the WildHands batch")
    W = lbs_weights(dev)
    lbs_group, lbs_extra = lbs_cases(gen, dev)

    def mask_check(n, g, r):
        return compare_abs(n, g, r, MASK_ABS)

    def grad_check(n, g, r):
        return compare_abs(n, g, r, GRAD_ATOL, GRAD_RTOL)

    def splat_cases(b, n_verts, res, sigma, layout="blob"):
        v2d = projected_vertices(gen, dev, b, n_verts, res, layout)
        pairs = b * res * res * n_verts
        # two special-function results a pair with g > 0 (exp and log1p
        # forward, exp and a division backward); a dense loop does them for
        # every pair
        live = splat_nonzero_pairs(v2d, res, sigma)
        # the gradient of a mean L1 mask loss against a random binary target
        target = (torch.rand((b, res, res), generator=gen, device=dev)
                  > 0.5).float()
        gmask = (torch.sign(ras.splat_silhouette_plain(v2d, res, sigma)
                            - target) / target.numel()).contiguous()
        grad = SplatGrad(v2d, res, sigma, gmask)
        tail = f"B={b} res={res} V={n_verts}" + (
            f" s={sigma:g}" if sigma != RENDER_SIGMA else "") + (
            f" {layout}" if layout != "blob" else "")
        fwd = Case(f"splat forward {tail}", lambda f: f(v2d, res, sigma),
                   [v2d], 2 * live, "sfu", None, mask_check,
                   saved_bytes=4 * b * res * res,  # the log-miss map
                   dense_ops=2 * pairs)
        bwd = Case(f"splat backward {tail}", grad, [v2d, gmask, gmask],
                   2 * live, "sfu", None, grad_check, dense_ops=2 * pairs)
        return fwd, bwd, grad

    fwd, bwd, grad = splat_cases(batch, N_VERTS, RENDER_RES, RENDER_SIGMA)
    fwd_s, bwd_s, grad_s = splat_cases(3, 50, 20, 2.0)
    fused, plain = ras.splat_silhouette_fused, ras.splat_silhouette_plain
    groups = [
        lbs_group,
        (K2, SRC_SPLAT, {"splat_fwd": (fused, plain, [fwd]),
                         "splat_bwd": (fused, plain, [bwd])}),
    ]
    extra = lbs_extra + [(fwd_s, fused, plain), (bwd_s, fused, plain)]

    # K2's gradient against the twin in f64, at 8 hands (the f64 pair tensors
    # of 64 would take 30 GB)
    def through_autograd(v2d, res, sigma, gmask):
        v = v2d.detach().clone().requires_grad_(True)
        return torch.autograd.grad(fused(v, res, sigma), v, gmask)[0]

    def f64_check(b, n_verts, res, sigma, layout="blob"):
        _, case, g32 = splat_cases(b, n_verts, res, sigma, layout)
        g64 = SplatGrad(g32.v2d.double(), res, sigma, g32.gmask.double())
        want = g64(plain)
        scale = float(want.abs().max())
        for label, fn in (("kernel", fused), ("f32 twin", plain)):
            got = (through_autograd(g32.v2d, res, sigma, g32.gmask)
                   if fn is fused else g32(fn))
            err = float((got.double() - want).abs().max()) / scale
            print(f"  {case.label} {label} vs f64 twin: max|d| / max|ref| "
                  f"{err:.3e}"
                  + (f" (<= {GRAD_F64_REL:g})" if fn is fused else ""))
            require(fn is plain or err <= GRAD_F64_REL,
                    "splat backward kernel disagrees with the f64 twin")
        g32.release()
        g64.release()

    f64_check(8, N_VERTS, RENDER_RES, RENDER_SIGMA)
    f64_check(3, 50, 20, 2.0)

    # K1's gradient through autograd: both kernels against the twin's; the
    # backward is one launch of lbs_apply_bwd and no product of the twin
    from torch.profiler import ProfilerActivity, profile

    v_posed, A = skinning_inputs(gen, dev, 3)
    g_out = torch.randn(v_posed.shape, generator=gen, device=dev)
    grads = []
    for fn in (ml.lbs_apply, ml.lbs_apply_plain):
        v, a = (t.clone().requires_grad_(True) for t in (v_posed, A))
        out = fn(v, W, a)
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            grads.append(torch.autograd.grad(out, (v, a), g_out))
        if fn is ml.lbs_apply:
            torch.cuda.synchronize()
            check_launches("lbs_apply backward", launch_counts(),
                           {"lbs_apply_bwd": 1}, 1)
            ops = sorted({e.key for e in prof.key_averages()
                          if e.key.startswith("aten::")})
            products = [k for k in ops if k in (
                "aten::einsum", "aten::bmm", "aten::mm", "aten::matmul")]
            print(f"  lbs_apply backward's aten ops: {', '.join(ops)}")
            require(not products, f"K1's backward ran the twin's {products}")
    for name, got, ref in zip(("d v_posed", "d A"), *grads):
        compare_abs(f"lbs_apply gradient {name}", got, ref, 1e-5, 1e-5)

    # K2 where the skipping differs: spread and off-canvas vertices, a sigma
    # that skips nothing, a canvas too large for the staged A map
    grads = [grad, grad_s]
    for b, n_verts, res, sigma, layout in SPLAT_CASES:
        fwd_c, bwd_c, grad_c = splat_cases(b, n_verts, res, sigma, layout)
        extra += [(fwd_c, fused, plain), (bwd_c, fused, plain)]
        grads.append(grad_c)
    for b, n_verts, res, sigma, layout in SPLAT_CASES:
        f64_check(min(b, 8), n_verts, res, sigma, layout)
    return groups, extra, grads


TP_RANKS = 2  # model ranks of phase 22 (two ranks sharing the card: gloo)


def tp_kernel_cases(x, p, heads=HEADS, ranks=TP_RANKS):
    """K3's kernels at the shapes one of ``ranks`` tensor-parallel ranks
    launches on ``x`` (B, N, C), its shard taken as ``shard_vit_tp`` takes
    rank 0's (qkv's rows {q, k, v} x the first heads / ranks heads): the
    GEMM's f32 partial-product form (``vit_gemm_f32``) at the row-parallel
    shapes a block launches (proj and MLP2, K C / ranks and hidden / ranks;
    its line of the kernels JSON, per block), and as extra cases that form
    at the column-parallel shapes and at 4x the rows, ``vit_gemm`` at the
    local qkv and MLP1, and the attention on heads / ranks heads. The
    library call of the f32 form is ``torch.mm`` with an f32 output."""
    from hands_tpu_torch.ops import vit_block as vb

    batch, n_tok, c = x.shape
    rows = batch * n_tok
    x2 = x.reshape(rows, c)
    hidden = p["w1"].shape[0]
    hl, cl, hid = heads // ranks, c // ranks, hidden // ranks
    d = c // heads
    wqkv = p["wqkv"].view(3, heads, d, c)[:, :hl].reshape(3 * cl, c)
    bqkv = p["bqkv"].view(3, heads, d)[:, :hl].reshape(-1).contiguous()
    wproj = p["wproj"][:, :cl].contiguous()
    w1, b1 = p["w1"][:hid].contiguous(), p["b1"][:hid].contiguous()
    w2 = p["w2"][:, :hid].contiguous()
    y = vb.layernorm_plain(x2, p["ln1_scale"], p["ln1_bias"])
    qkv3 = vb.gemm_plain(y, wqkv, bqkv).view(batch, n_tok, 3 * cl)
    o = vb.attention_plain(qkv3, hl).view(rows, cl)
    h = vb.gemm_plain(y, w1, b1, "gelu")
    o4, h4 = o.repeat(4, 1), h.repeat(4, 1)

    def partial(label, a, w):
        return Case(f"gemm_f32 {label} (N {w.shape[0]}, K {w.shape[1]})",
                    lambda f: f(a, w), [a, w],
                    2 * a.shape[0] * w.shape[0] * w.shape[1], "bf16",
                    lambda: torch.mm(a, w.t(), out_dtype=torch.float32))

    t = qkv3.view(batch, n_tok, 3, hl, d).permute(2, 0, 3, 1, 4)
    group = {"vit_gemm_f32": (vb.gemm_partial, vb.gemm_partial_plain, [
        partial("proj", o, wproj), partial("mlp2", h, w2)])}
    extra = [(partial("qkv shape", y, wqkv), vb.gemm_partial,
              vb.gemm_partial_plain),
             (partial("mlp1 shape", y, w1), vb.gemm_partial,
              vb.gemm_partial_plain),
             (partial(f"proj {4 * rows} rows", o4, wproj), vb.gemm_partial,
              vb.gemm_partial_plain),
             (partial(f"mlp2 {4 * rows} rows", h4, w2), vb.gemm_partial,
              vb.gemm_partial_plain),
             (Case(f"gemm qkv {hl} heads", lambda f: f(y, wqkv, bqkv),
                   [y, wqkv, bqkv], 2 * rows * 3 * cl * c, "bf16",
                   lambda: F.linear(y, wqkv, bqkv)), vb.gemm, vb.gemm_plain),
             (Case(f"gemm mlp1+gelu {hid} cols", lambda f: f(y, w1, b1, "gelu"),
                   [y, w1, b1], 2 * rows * hid * c, "bf16",
                   lambda: F.linear(y, w1, b1)), vb.gemm, vb.gemm_plain),
             (Case(f"attention {hl} heads", lambda f: f(qkv3, hl), [qkv3],
                   4 * batch * hl * n_tok * n_tok * d, "bf16",
                   lambda: F.scaled_dot_product_attention(t[0], t[1], t[2])),
              vb.attention, vb.attention_plain)]
    for case in group["vit_gemm_f32"][2] + [e[0] for e in extra]:
        if case.inputs[0].shape[0] <= rows:
            case.timer = short_ms
    return [(K3, SRC_K3, group)], extra


def check_extra(extra) -> None:
    """Hold each of the extra shapes' kernels against its twin; a splat
    gradient lets go of its graphs (the twin's hold the pair tensors)."""
    for case, kfn, pfn in extra:
        case.check(case.label, case.call(kfn), case.call(pfn))
        if isinstance(case.call, SplatGrad):
            case.call.release()
    torch.cuda.synchronize()


def replaced_note(case) -> str:
    """The time of the path ``case``'s kernel replaced, best of two."""
    if case.replaced is None:
        return ""
    label, fn = case.replaced
    return (f", replaced path ({label}) "
            f"{min(case.timer(fn) for _ in range(2)):.4f} ms")


def time_extra(extra, tag) -> None:
    """Time each extra shape's kernel beside its twin and library call."""
    for case, kfn, pfn in extra:
        km = min(case.timer(lambda: case.call(kfn)) for _ in range(2))
        pm = min(case.timer(lambda: case.call(pfn)) for _ in range(2))
        lib = ("none" if case.library is None else
               f"{min(case.timer(case.library) for _ in range(2)):.4f} ms")
        ref = case.call(pfn)
        bound = max(*case.bound(ref))
        print(f"    {case.label:<34s} kernel {km:.4f} ms ({bound / km:.1%} "
              f"of the bound), plain {pm:.4f} ms, library {lib}"
              f"{replaced_note(case)}, bound {bound:.4f} ms"
              f"{case.dense_bound(ref)} {tag}")
        del ref
        if isinstance(case.call, SplatGrad):
            case.call.release()


def splat_blob(groups):
    """(v2d, res, sigma) of K2's main-path case in ``groups``."""
    fwd = {k: v for _, _, ks in groups for k, v in ks.items()}["splat_fwd"]
    return fwd[2][0].inputs[0], RENDER_RES, RENDER_SIGMA


def check_groups(groups, sources, rows) -> None:
    """Hold every kernel of ``groups`` (the format of :func:`kernel_cases`)
    against its twin and start its line of the kernels JSON in ``rows``."""
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


def time_groups(groups, rows, tag, earlier=True) -> None:
    """Time every kernel of ``groups`` beside its twin and its library call
    and complete its line in ``rows``; ``earlier``: print the time of the
    design a redesigned kernel replaced (:data:`EARLIER_MS`) beside it."""
    for replaces, source, kernels in groups:
        for kname, (kfn, pfn, cases) in kernels.items():
            def each(fn):
                return [case.timer(lambda c=case: c.call(fn))
                        for case in cases]

            def library():
                return [None if c.library is None else c.timer(c.library)
                        for c in cases]

            def yardstick():
                return [None if c.yardstick is None
                        else c.timer(c.yardstick[1]) for c in cases]

            # in turns: plain, kernel, library and yardstick twice, kernel,
            # plain; the better of each pair of reads
            a, b, lb, ys, lb2, ys2, b2, a2 = (
                each(pfn), each(kfn), library(), yardstick(), library(),
                yardstick(), each(kfn), each(pfn))
            k_ms = [min(u, v) for u, v in zip(b, b2)]
            p_ms = [min(u, v) for u, v in zip(a, a2)]
            l_ms = [None if u is None else min(u, v) for u, v in zip(lb, lb2)]
            y_ms = [None if u is None else min(u, v) for u, v in zip(ys, ys2)]
            for case, km, pm, lm, ym in zip(cases, k_ms, p_ms, l_ms, y_ms):
                bound = max(*case.bound(case.call(pfn)))
                lib = "none" if lm is None else f"{lm:.4f} ms"
                unit = "TOP/s" if case.kind == "int8" else "TFLOP/s"
                # a graph-timed case: the events reading of back-to-back
                # calls and the wrapper's host time beside it
                host = ""
                if case.timer is not cuda_ms:
                    ev = [cuda_ms(f) for f in (lambda c=case: c.call(kfn),
                                               case.library) if f]
                    host = (f", by events {ev[0]:.4f} ms" + (
                        f" (library {ev[1]:.4f} ms)" if len(ev) > 1 else "")
                        + f", host {host_ms(lambda c=case: c.call(kfn)):.4f}"
                        f" ms a call")
                yard = ("" if ym is None else f", yardstick {ym:.4f} ms "
                        f"({case.yardstick[0]}: not the same function)")
                print(f"    {case.label:<34s} kernel {km:.4f} ms "
                      f"({case.ops / km / 1e9:.1f} {unit}, {bound / km:.1%} "
                      f"of the bound), plain {pm:.4f} ms, library {lib}"
                      f"{yard}{replaced_note(case)}, bound {bound:.4f} ms"
                      f"{case.dense_bound(case.call(pfn))}{host}")
            # per block: the sum over this kernel's launch shapes
            row = rows[kname]
            row["ms"], row["plain_ms"] = sum(k_ms), sum(p_ms)
            row["library_ms"] = (None if any(v is None for v in l_ms)
                                 else sum(l_ms))
            lib = ("none" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms")
            before = ""
            if earlier and kname in EARLIER_MS:
                design, ms = EARLIER_MS[kname]
                row["redesigned"] = f"from {design}"
                before = f", before the redesign ({design}) {ms:.4f} ms"
            print(f"  {kname:<22s} per block or call: kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"library {lib}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}){before} {tag}")


def only(groups, names):
    """``groups`` (the format of :func:`kernel_cases`) cut to ``names``."""
    return [(r, src, {k: v for k, v in ks.items() if k in names})
            for r, src, ks in groups]


def gemm_shape_cases(gen, dev, M, N, k_bf16, k_i8):
    """Every epilogue of the two GEMM main loops at one (M, N) on seeded
    random operands, in the format of :func:`kernel_cases`: the bf16 block's
    four, the int8 blocks' seven, K8's three (its bare cast keeps an odd
    number of columns)."""
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8

    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, std=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def uniform(*shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    a, w = randn(M, k_bf16, dtype=bf), randn(N, k_bf16, std=k_bf16**-0.5,
                                             dtype=bf)
    bias, res = randn(N, std=0.1, dtype=bf), randn(M, N, dtype=bf)
    bf16_cases = [
        Case(f"gemm {e or 'bias'} ({M}, {N}, {k_bf16})",
             lambda f, e=e: f(a, w, bias, e, res if e == "residual" else None),
             [a, w, bias] + ([res] if e == "residual" else []),
             2 * M * N * k_bf16, "bf16", lambda: F.linear(a, w, bias))
        for e in (None, "gelu", "gelu_tanh", "residual")]

    # |acc| ~ 2e5 at K ~ 1300: scales that put the dequantised values at
    # tens, and the quantised ones over the int8 range
    aq, wq = int8(M, k_i8), int8(N, k_i8)
    sr, sc = uniform(M, 1, lo=0.005, hi=0.02), uniform(N, lo=0.005, hi=0.02)
    d, inv = uniform(N, lo=5e-5, hi=2e-4), uniform(N, lo=0.5, hi=4.0)
    b32, r32 = randn(N, std=4.0), randn(M, N, std=4.0)
    rbf = randn(M, N, std=4.0, dtype=bf)
    shape = f"({M}, {N}, {k_i8})"

    def i8(label, call, inputs, check):
        return Case(f"{label} {shape}", call, [aq, wq] + inputs,
                    2 * M * N * k_i8, "int8",
                    lambda: torch._int_mm(aq, wq.t()), check)

    dyn = [i8(f"gemm_i8 dynamic {e}", lambda f, kw=kw: f(
        aq, wq, sc, b32, row_scale=sr, **kw),
        [sr, sc, b32] + ([r32] if "residual" in kw else []), check)
        for e, kw, check in (
            ("bias", {}, compare_equal),
            ("residual f32", dict(epilogue="residual", residual=r32,
                                  out_dtype=f32), compare_equal),
            ("residual bf16", dict(epilogue="residual", residual=r32,
                                   out_dtype=bf), compare_equal),
            ("gelu", dict(epilogue="gelu", out_dtype=f32), compare_gelu_gemm),
            ("gelu_tanh", dict(epilogue="gelu", out_dtype=f32,
                               fast_gelu=True), compare_gelu_gemm))]
    sta = [i8(f"gemm_i8 static {e}", lambda f, kw=kw: f(aq, wq, d, b32, **kw),
              [d, b32] + inputs, check)
           for e, kw, inputs, check in (
               ("bias", {}, [], compare_equal),
               ("residual", dict(epilogue="residual", residual=rbf), [rbf],
                compare_equal),
               ("gelu+quant", dict(epilogue="gelu", inv_next=inv), [inv],
                compare_gelu_gemm),
               ("gelu_tanh+quant", dict(epilogue="gelu", inv_next=inv,
                                        fast_gelu=True), [inv],
                compare_gelu_gemm))]
    keep = N // 3 | 1
    abl_mm, abl_plain = abl.gemm_i8_ablation, abl.gemm_i8_ablation_plain
    kernels = {
        "vit_gemm": (vb.gemm, vb.gemm_plain, bf16_cases),
        "gemm_i8_dynamic": (v8.gemm_i8, v8.gemm_i8_plain, dyn),
        "gemm_i8_static": (v8.gemm_i8, v8.gemm_i8_plain, sta),
        "gemm_i8_gelu_cast": (abl_mm, abl_plain, [
            i8("gemm_i8 gelu_tanh, bare cast", lambda f: f(
                aq, wq, d, b32, "gelu_cast", inv, True), [d, b32, inv],
               compare_gelu_gemm)]),
        "gemm_i8_ident_quant": (abl_mm, abl_plain, [
            i8("gemm_i8 identity, quantise", lambda f: f(
                aq, wq, d, b32, "ident_quant", inv), [d, b32, inv],
               compare_equal)]),
        "gemm_i8_cast": (abl_mm, abl_plain, [
            i8(f"gemm_i8 bare cast, {keep} columns", lambda f: f(
                aq, wq, d, b32, "cast", keep_cols=keep), [d, b32],
               compare_equal)]),
    }
    return [(f"GEMMs at ({M}, {N})", SRC_GEMM, kernels)]


def gemm_extra(extra):
    """The GEMM cases of :func:`kernel_cases`' ``extra`` list."""
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8

    return [e for e in extra if e[1] in (vb.gemm, v8.gemm_i8)]


def gemm_ragged_check(gen, dev) -> None:
    """Every GEMM epilogue at :data:`RAGGED_GEMM` against its twin."""
    M, N, k_bf16, k_i8 = RAGGED_GEMM
    print(f"  GEMMs off every tile: M={M}, N={N}, K={k_bf16} (bf16) / {k_i8} "
          f"(int8)")
    check_groups(gemm_shape_cases(gen, dev, M, N, k_bf16, k_i8), {}, {})
    torch.cuda.synchronize()


def require_refused(name, call) -> None:
    """``call`` on the card raises the wrapper's ValueError and launches
    nothing."""
    before = launch_counts()
    try:
        call()
    except ValueError as err:
        require(launch_counts() == before, f"{name}: launched")
        print(f"  {name:<34s} refused: {err}")
        return
    raise AssertionError(f"{name}: the wrapper took a shape past its limits")


def require_c_refused(name, call) -> None:
    """``call``, a C entry through ``LIBRARY.launch`` past the wrapper,
    returns cudaErrorInvalidValue before it launches anything."""
    try:
        call()
    except RuntimeError as err:
        require("invalid argument" in str(err), f"{name}: {err}")
        print(f"  {name:<34s} refused by the C entry: {err}")
        return
    raise AssertionError(f"{name}: the C entry took a shape past its limits")


def layernorm_ragged_check(gen, dev) -> None:
    """K3's LayerNorm at :data:`LN_RAGGED` against its twin; a width it does
    not take is refused."""
    from hands_tpu_torch.ops import vit_block as vb

    counts, widths = LN_RAGGED
    for c in widths:
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bias = 0.1 * torch.randn(c, generator=gen, device=dev)
        for r in counts:
            x = (3.0 * torch.randn((r, c), generator=gen, device=dev)
                 + 0.5).to(torch.bfloat16)
            compare(f"vit_layernorm rows {r} C {c}", vb.layernorm(x, scale,
                                                                  bias),
                    vb.layernorm_plain(x, scale, bias))
    torch.cuda.synchronize()
    x = torch.zeros((4, 1284), dtype=torch.bfloat16, device=dev)
    ones = torch.ones(1284, device=dev)
    require_refused("vit_layernorm C 1284",
                    lambda: vb.layernorm(x, ones, ones))


def bwd_ragged_check(gen, dev) -> None:
    """K4's backward kernels off the ViT-H shapes, against their twins:
    ``attention_bwd`` at :data:`ATTN_SWEEP` (two heads), ``layernorm_bwd``
    at :data:`LN_RAGGED`, ``gelu_bwd`` on value counts off its vectors of 8
    (both forms); then the shapes each refuses."""
    from hands_tpu_torch.ops import vit_block as vb

    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device=dev)).to(bf)

    for b, n, d in ATTN_SWEEP:
        qkv, do = randn(b, n, 6 * d), randn(b, n, 2 * d, std=0.1)
        compare_dqkv(f"attention_bwd B {b} N {n} D {d}",
                     vb.attention_bwd(qkv, do, 2),
                     vb.attention_bwd_plain(qkv, do, 2))
    counts, widths = LN_RAGGED
    for c in widths:
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        for r in counts:
            x = (3.0 * torch.randn((r, c), generator=gen, device=dev)
                 + 0.5).to(bf)
            dy, g = randn(r, c, std=0.1), randn(r, c, std=0.1)
            compare_ln_bwd(f"layernorm_bwd rows {r} C {c}",
                           vb.layernorm_bwd(x, dy, scale, g),
                           vb.layernorm_bwd_plain(x, dy, scale, g))
    for shape in ((7,), (13, 1283)):
        u, dh = randn(*shape, std=2.5), randn(*shape, std=0.1)
        for fast in (False, True):
            compare_ulps(f"gelu_bwd {shape} {'tanh' if fast else 'erf'}",
                         vb.gelu_bwd(u, dh, fast),
                         vb.gelu_bwd_plain(u, dh, fast))
    torch.cuda.synchronize()
    big = randn(1, 257, 384)
    require_refused("attention_bwd N 257", lambda: vb.attention_bwd(
        big, big[..., :128].contiguous(), 2))
    odd = randn(1, 13, 120)
    require_refused("attention_bwd D 20", lambda: vb.attention_bwd(
        odd, odd[..., :40].contiguous(), 2))
    x = torch.zeros((4, 1284), dtype=bf, device=dev)
    ones = torch.ones(1284, device=dev)
    require_refused("layernorm_bwd C 1284",
                    lambda: vb.layernorm_bwd(x, x, ones, x))
    require_refused("gelu_bwd f32", lambda: vb.gelu_bwd(
        ones, ones.to(bf), False))


def ln_quant_ragged_check(gen, dev) -> None:
    """K5/K6's LayerNorm + quantise at :data:`LN_RAGGED`, both forms, bf16
    and f32 rows, against its twin; at 3077 rows every other row has a mean
    large against its spread (:data:`LNQ_CANCEL_MEAN`); K8's ``ln_cast``
    and ``ln_affine_quant`` on the same bf16 rows, bit-equal wherever the
    twin's reduction takes a warp per row (C > 128, 16 rows or more; else
    within one int8 step, bit-equality reported) and ``ln_affine_quant``
    everywhere; a width the kernels do not take is refused by the wrappers
    and by the C entries."""
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8

    counts, widths = LN_RAGGED
    for c in widths:
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bias = 0.1 * torch.randn(c, generator=gen, device=dev)
        for r in counts:
            x = 3.0 * torch.randn((r, c), generator=gen, device=dev) + 0.5
            spread = 6.0 * torch.randn((r, c), generator=gen, device=dev)
            for dynamic in (True, False):
                form = "dynamic" if dynamic else "static"
                # the static form's scale and bias arrive divided by an
                # activation scale (1/30 here): values over the int8 range
                mul = 1.0 if dynamic else 30.0
                xr = x.clone()
                if r >= counts[-1]:
                    xr[::2] = spread[::2] + 6.0 * LNQ_CANCEL_MEAN[dynamic]
                for dtype in (torch.bfloat16, torch.float32):
                    xt = xr.to(dtype)
                    compare_int8(
                        f"ln_quant {form} {str(dtype)[6:]} rows {r} C {c}",
                        v8.ln_quant(xt, scale * mul, bias * mul, dynamic),
                        v8.ln_quant_plain(xt, scale * mul, bias * mul,
                                          dynamic))
            # K8's knock-outs on the static form's rows, values over the
            # range of the cast and of the quantisation
            xt = xr.to(torch.bfloat16)
            in_order = r >= 16 and c > 128
            for name, no_ln, cast in (("ln_cast", False, True),
                                      ("ln_affine_quant", True, False)):
                check = compare_equal if in_order or no_ln else compare_int8
                check(f"{name} rows {r} C {c}",
                      abl.ln_ablation(xt, scale * 30.0, bias * 30.0, no_ln,
                                      cast),
                      abl.ln_ablation_plain(xt, scale * 30.0, bias * 30.0,
                                            no_ln, cast))
    torch.cuda.synchronize()
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((4, 1284), dtype=dtype, device=dev)
        ones = torch.ones(1284, device=dev)
        require_refused(f"ln_quant {str(dtype)[6:]} C 1284",
                        lambda: v8.ln_quant(x, ones, ones, True))
    x = torch.zeros((4, 1284), dtype=torch.bfloat16, device=dev)
    q = torch.empty((4, 1284), dtype=torch.int8, device=dev)
    for name, no_ln, cast in (("ln_cast", False, True),
                              ("ln_affine_quant", True, False)):
        require_refused(f"{name} C 1284",
                        lambda: abl.ln_ablation(x, ones, ones, no_ln, cast))
        require_c_refused(f"abl_ln ({name}) C 1284",
                          lambda: abl.LIBRARY.launch(
                              "abl_ln", x.device, x.data_ptr(),
                              ones.data_ptr(), ones.data_ptr(), q.data_ptr(),
                              4, 1284, 1e-6, int(no_ln), int(cast)))


def heads_split_case(qkv3, heads) -> Case:
    """K8's head-major relayout of a (B, N, 3C) qkv, bit-equal to its twin,
    timed through a CUDA graph beside ``permute().contiguous()``."""
    B, N, c3 = qkv3.shape
    t5 = qkv3.view(B, N, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return Case("attn_merged: qkv to head-major",
                lambda f: f(qkv3, heads), [qkv3], 0, "f32",
                lambda: t5.contiguous(), check=compare_equal, timer=short_ms)


def heads_split_check(gen, dev) -> None:
    """K8's ``heads_split`` and ``heads_merge_quant`` at
    :data:`SPLIT_RAGGED`, each also from an input that starts 4 bytes past a
    16-byte boundary (it must take the 4-byte form), bit-equal to their
    twins; an odd head dim (split) and head rows that do not divide into the
    heads (merge) are refused, and the merge's C entry refuses 16-byte reads
    from that input."""
    from hands_tpu_torch.ops import vit_block_ablation as abl

    for b, n, h, d in SPLIT_RAGGED:
        size = b * n * 3 * h * d
        buf = torch.randn(size + 8, generator=gen, device=dev).to(
            torch.bfloat16)
        for off in (0, 2):  # bf16 elements: 0 and 4 bytes past the boundary
            qkv = buf[off:off + size].view(b, n, 3 * h * d)
            width = abl.split_vector_bytes(d, qkv.data_ptr())
            require(width == (16 if d % 8 == 0 and off == 0 else 4),
                    f"heads_split D {d} offset {off}: {width}-byte form")
            compare_equal(f"heads_split B {b} N {n} H {h} D {d} +{2 * off} B "
                          f"({width}-byte form)", abl.heads_split(qkv, h),
                          abl.heads_split_plain(qkv, h).contiguous())
        c = h * d
        inv = 10.0 + 50.0 * torch.rand(c, generator=gen, device=dev)
        buf = 3.0 * torch.randn(size // 3 + 4, generator=gen, device=dev)
        for off in (0, 1):  # f32 elements: 0 and 4 bytes past the boundary
            o = buf[off:off + size // 3].view(b * h, n, d)
            width = abl.merge_vector_bytes(d, o.data_ptr(), inv.data_ptr())
            require(width == (16 if d % 4 == 0 and off == 0 else 4),
                    f"heads_merge_quant D {d} offset {off}: {width}-byte form")
            compare_equal(f"heads_merge_quant B {b} N {n} H {h} D {d} "
                          f"+{4 * off} B ({width}-byte form)",
                          abl.heads_merge_quant(o, inv, h),
                          abl.heads_merge_quant_plain(o, inv, h))
    torch.cuda.synchronize()
    qkv = torch.zeros((1, 13, 3 * 3 * 5), dtype=torch.bfloat16, device=dev)
    require_refused("heads_split D 5", lambda: abl.heads_split(qkv, 3))
    o = torch.zeros((4, 13, 80), device=dev)
    inv = torch.ones(3 * 80, device=dev)
    require_refused("heads_merge_quant 4 head rows, 3 heads",
                    lambda: abl.heads_merge_quant(o, inv, 3))
    out = torch.empty((1, 13, 3 * 80), dtype=torch.int8, device=dev)
    require_c_refused("abl_heads_merge_quant 16 B at +4 B",
                      lambda: abl.LIBRARY.launch(
                          "abl_heads_merge_quant", dev, o.data_ptr() + 4,
                          inv.data_ptr(), out.data_ptr(), 1, 13, 3, 80, 16))


def k8_vector_check(gen, dev) -> None:
    """K8's ``cast_rows`` and ``qslice_quant`` off the 256-crop shape,
    bit-equal to their twins: ``cast_rows`` at :data:`CAST_RAGGED` on
    values that hold :data:`CAST_EDGES`, each also from ``x`` 2 and 4 bytes
    past a 16-byte boundary (it must take the 2- and 4-byte forms);
    ``qslice_quant`` at :data:`QSLICE_RAGGED`, products past +-127 and on
    exact .5 ties, in the form each width takes. A wrapper refuses what it
    does not take, and each C entry a width that the pointers or C do not
    allow."""
    from hands_tpu_torch.ops import vit_block_ablation as abl

    edges = torch.tensor(CAST_EDGES, device=dev)
    for shape in CAST_RAGGED:
        shape = shape if isinstance(shape, tuple) else (shape,)
        n = math.prod(shape)
        v = 150.0 * torch.randn(n + 8, generator=gen, device=dev)
        k = v[::3].numel()
        v[::3] = edges.repeat(k // edges.numel() + 1)[:k]
        buf = v.to(torch.bfloat16)
        for off, width in ((0, 16), (1, 2), (2, 4)):  # bf16 elements
            x = buf[off:off + n].view(shape)
            got = abl.cast_vector_bytes(x.data_ptr(), 16)
            require(got == width, f"cast_rows +{2 * off} B: {got}-byte form")
            compare_equal(f"cast_rows {'x'.join(map(str, shape))} +{2 * off} "
                          f"B ({width}-byte form)", abl.cast_rows(x),
                          abl.cast_rows_plain(x))
    counts, widths = QSLICE_RAGGED
    for c3, width in widths.items():
        c = c3 // 3
        inv = 0.5 + 5.5 * torch.rand(c, generator=gen, device=dev)
        inv[::3] = 1.0
        for r in counts:
            v = 40.0 * torch.randn((1, r, c3), generator=gen, device=dev)
            half = torch.randint(-127, 127, v.view(-1)[::5].shape,
                                 generator=gen, device=dev)
            v.view(-1)[::5] = half + 0.5
            qkv = v.to(torch.bfloat16)
            got = abl.qslice_vector_bytes(c, c3, qkv.data_ptr(),
                                          inv.data_ptr(), 0)
            require(got == width, f"qslice_quant C3 {c3}: {got}-byte form")
            y = qkv[..., :c].float() * inv
            compare_equal(f"qslice_quant rows {r} C {c} C3 {c3} ({width}-"
                          f"byte form; {int((y.abs() > 127.5).sum())} past "
                          f"127, {int((y.frac().abs() == 0.5).sum())} ties)",
                          abl.qslice_quant(qkv, inv),
                          abl.qslice_quant_plain(qkv, inv))
    torch.cuda.synchronize()
    x = torch.zeros((1283, 13), dtype=torch.bfloat16, device=dev)
    q = torch.empty(1283 * 13 + 16, dtype=torch.int8, device=dev)
    require_refused("cast_rows of a transposed x",
                    lambda: abl.cast_rows(x.t()))
    require_c_refused("abl_cast_rows 16 B at +2 B",
                      lambda: abl.LIBRARY.launch(
                          "abl_cast_rows", dev, x.data_ptr() + 2,
                          q.data_ptr(), 1283 * 13 - 1, 16))
    qkv = torch.zeros(13 * 3852 + 8, dtype=torch.bfloat16, device=dev)
    inv = torch.ones(1284, device=dev)
    require_refused("qslice_quant qkv at +4 B", lambda: abl.qslice_quant(
        qkv[2:2 + 13 * 3852].view(1, 13, 3852), inv))
    require_c_refused("abl_qslice_quant 16 B at C 1284",
                      lambda: abl.LIBRARY.launch(
                          "abl_qslice_quant", dev, qkv.data_ptr(),
                          inv.data_ptr(), q.data_ptr(), 13, 1284, 3852, 16))


def one_crop_check(x, op_dynamic) -> None:
    """K5's whole dynamic int8 block at one crop (192 rows: PyTorch's row
    reductions still give a row to a warp, in ``warp_row_stats``' order)
    against its twin, to the whole-block limits (mean 1e-3)."""
    from hands_tpu_torch.ops import vit_block_int8 as v8

    x1 = x[:1]
    compare(f"whole dynamic int8 block, one crop ({x1.shape[1]} rows)",
            v8.vit_block_fused_int8(x1, op_dynamic, num_heads=HEADS),
            v8.vit_block_int8_plain(x1, op_dynamic, HEADS), rel=BLOCK_REL)


def gemm_serving_phase(gen, dev, tag,
                       names=GEMM_KERNELS + ROW_PASSES) -> None:
    """The serving GEMMs and the LayerNorm passes (or the kernels of
    ``names``) at the bs64 batch (:data:`GEMM_SERVE_BATCH` crops, 24,576
    rows) against their twins, timed beside the library call; their lines stay out of the
    kernels JSON (per ViT-H block at 3072 rows)."""
    x, p, p32 = block_inputs(gen, dev, GEMM_SERVE_BATCH, N_TOK, C, HIDDEN)
    groups, sources, extra, _ = kernel_cases(x, p, p32)
    groups = only(groups, names)
    print(f"  {', '.join(names)} at {GEMM_SERVE_BATCH * N_TOK} rows "
          f"({GEMM_SERVE_BATCH} crops) {tag}")
    rows = {}
    check_groups(groups, sources, rows)
    for case, kfn, pfn in (gemm_extra(extra)
                           if set(names) & set(GEMM_KERNELS) else []):
        case.check(case.label, case.call(kfn), case.call(pfn))
    time_groups(groups, rows, tag, earlier=False)
    del groups, extra, x, p, p32
    torch.cuda.empty_cache()


def f32p_attention(qkv, heads, bf16_logits, p_bf16=False,
                   dtype=torch.float32):
    """The attention of K3 (``bf16_logits``) or K5 on (B, N, 3C) bf16 qkv,
    sums and softmax in ``dtype`` (f64: a reference for the twins' f32), bf16
    out; ``p_bf16`` rounds the probabilities to bf16 before p.v, as a kernel
    that did not split them into bf16 parts would."""
    from hands_tpu_torch.ops import vit_block as vb

    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    t = qkv.view(B, N, 3, heads, D).permute(2, 0, 3, 1, 4)
    q = t[0] * vb.bf16_const(D**-0.5)
    s = torch.matmul(q.to(dtype), t[1].to(dtype).transpose(-1, -2))
    if bf16_logits:
        s = s.to(torch.bfloat16).to(dtype)
    p = torch.softmax(s, dim=-1)
    if p_bf16:
        p = p.to(torch.bfloat16).to(dtype)
    o = torch.matmul(p, t[2].to(dtype))
    return o.permute(0, 2, 1, 3).reshape(B, N, C).to(torch.bfloat16)


def attention_phase(dev, qkv_k3, qkv_dyn) -> None:
    """The tensor-core attention beyond the ViT-H shapes of phase 2: every
    mode against its twin at the ragged shapes of ``ATTN_SWEEP``, f32
    ``mha_fused`` also at :data:`F32_RAGGED`, from a 4-byte aligned qkv, on
    the CUDA-core loop at ViT-H, and refused at N 256, D 128; the split of
    the f32 probabilities into bf16 parts in effect (K3, K5 at ViT-H)."""
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_ablation as abl

    bf, heads = torch.bfloat16, 2
    print(f"phase 2b: attention, every mode at ragged shapes ({heads} heads)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    gen32 = torch.Generator(device=dev).manual_seed(SEED + 7)
    for b, n, d in ATTN_SWEEP:
        c = heads * d
        qkv = torch.randn((b, n, 3 * c), generator=gen, device=dev).to(bf)
        inv = 20.0 + 130.0 * torch.rand(c, generator=gen, device=dev)
        at_ = f"B {b} N {n} D {d}"
        compare(f"vit_attention {at_}", vb.attention(qkv, heads),
                vb.attention_plain(qkv, heads))
        compare(f"qkv dynamic {at_}", at.qkv_attention(qkv, heads),
                at.qkv_attention_plain(qkv, heads))
        compare_int8(f"qkv static {at_}", at.qkv_attention(qkv, heads, inv),
                     at.qkv_attention_plain(qkv, heads, inv))
        for variant in ("cast", "no_softmax"):
            compare_int8(f"attention_{variant} {at_}",
                         abl.attention_ablation(qkv, heads, inv, variant),
                         abl.attention_ablation_plain(qkv, heads, inv,
                                                      variant))
        qkvh = abl.heads_split_plain(qkv, heads).contiguous()
        compare(f"attention_heads {at_}", abl.attention_heads(qkvh),
                abl.attention_heads_plain(qkvh))
        compare_int8(f"attention_i8 {at_}", abl.attention_i8(qkv, heads, inv),
                     abl.attention_i8_plain(qkv, heads, inv))
        t5 = qkv.view(b, n, 3, heads, d)
        q, k, v = t5[:, :, 0], t5[:, :, 1], t5[:, :, 2]
        compare(f"mha_fused bfloat16 {at_}", at.mha_fused(q, k, v, d**-0.5),
                at.mha_plain(q, k, v, d**-0.5))
        # f32 values (not bf16 ones widened, which tf32 holds exactly)
        f32_route_check(f"mha_fused float32 {at_}",
                        torch.randn(t5.shape, generator=gen32, device=dev),
                        "mha_fused_f32")
    for b, n, d in ATTN_I8_SWEEP[len(ATTN_SWEEP):]:
        c = heads * d
        qkv = torch.randn((b, n, 3 * c), generator=gen, device=dev).to(bf)
        inv = 20.0 + 130.0 * torch.rand(c, generator=gen, device=dev)
        compare_int8(f"attention_i8 B {b} N {n} D {d}",
                     abl.attention_i8(qkv, heads, inv),
                     abl.attention_i8_plain(qkv, heads, inv))
    for b, n, d, route in F32_RAGGED:
        f32_route_check(f"mha_fused float32 B {b} N {n} D {d}",
                        torch.randn((b, n, 3, heads, d), generator=gen32,
                                    device=dev), route)
    # a 4-byte aligned qkv: the tensor-core route's 4-byte copies
    flat = torch.randn(145 * 3 * heads * 64 + 1, generator=gen32, device=dev)
    f32_route_check("mha_fused float32 N 145 D 64 +4 B",
                    flat[1:].view(1, 145, 3, heads, 64), "mha_fused_f32")
    # the CUDA-core loop at ViT-H, the route the tensor cores replaced there
    t = torch.randn((BATCH, N_TOK, 3, HEADS, HEAD_DIM), generator=gen32,
                    device=dev)
    compare("mha_f32_cores (ViT-H, 3072 rows)",
            at.mha_f32_cores(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                             HEAD_DIM**-0.5),
            at.mha_plain(t[:, :, 0], t[:, :, 1], t[:, :, 2], HEAD_DIM**-0.5),
            rel=2e-5, mean=2e-6)
    del t
    torch.cuda.synchronize()
    qkv = torch.zeros((1, 257, 3 * heads * 64), dtype=bf, device=dev)
    inv = torch.ones(heads * 64, device=dev)
    require_refused("attention_i8 N 257",
                    lambda: abl.attention_i8(qkv, heads, inv))
    t = torch.zeros((1, 256, 3, heads, 128), device=dev)
    require_refused("mha_fused float32 N 256 D 128",
                    lambda: at.mha_fused(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                         1.0))

    # the split of f32 probabilities: nearer the f32-probability twin than p
    # in bf16 is
    for name, kern, qkv, bf16_logits, twin in (
            ("vit_attention (K3)", vb.attention, qkv_k3, True,
             vb.attention_plain),
            ("qkv_attention_dynamic (K5)", at.qkv_attention, qkv_dyn, False,
             at.qkv_attention_plain)):
        got, ref = kern(qkv, HEADS), twin(qkv, HEADS)
        d_f32 = float((got.float() - ref.float()).abs().mean())
        d_bf16 = float((got.float() - f32p_attention(
            qkv, HEADS, bf16_logits, p_bf16=True).float()).abs().mean())
        print(f"  {name}: mean|d| against the f32-probability twin "
              f"{d_f32:.3e}, against it with p in bf16 {d_bf16:.3e}  "
              f"{'ok' if d_f32 < d_bf16 else 'FAIL'}")
        require(d_f32 < d_bf16,
                f"{name}: the split of the probabilities is not in effect")
        # rounded to another bf16 value than the f64 attention: the kernel's
        # share may not exceed twice the f32 twin's
        f64 = f32p_attention(qkv, HEADS, bf16_logits, dtype=torch.float64)
        k_off = float((got != f64).float().mean())
        t_off = float((ref != f64).float().mean())
        ok = k_off <= 2 * t_off
        print(f"  {name}: outputs off the f64 attention's bf16 value: kernel "
              f"{k_off:.3e}, twin {t_off:.3e} (kernel <= 2x twin)  "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name}: the kernel's sums fall behind the twin's f32")


def f32_route_check(name, t5, route) -> None:
    """f32 ``mha_fused`` on the slices of a (B, N, 3, H, D) qkv against
    ``mha_plain`` at 2e-5 / 2e-6, launched once on ``route`` (the name of its
    launch count)."""
    from hands_tpu_torch.ops import attention as at

    q, k, v = t5[:, :, 0], t5[:, :, 1], t5[:, :, 2]
    scale = t5.shape[-1]**-0.5
    before = dict(at.launches)
    got = at.mha_fused(q, k, v, scale)
    moved = {key: n - before[key] for key, n in at.launches.items()
             if n != before[key]}
    require(moved == {route: 1}, f"{name}: launches {moved}, want {route}")
    compare(name, got, at.mha_plain(q, k, v, scale), rel=2e-5, mean=2e-6)


def f32_backbone_phase(rows, dev, tag) -> None:
    """K7's f32 route on its path: one full-width f32 ViT-H backbone
    forward with ``fused_attn`` at 16 crops (3072 rows), TF32 off for the
    other products as is the card's default for matrix products (and here
    for cuDNN's patch embedding too): ``mha_fused_f32`` once a block, nothing
    else; the features against the same backbone with ``mha_plain`` patched
    in (:data:`F32_BACKBONE_REL`); both forwards timed by events."""
    from hands_tpu_torch.models.backbones import vit as vit_mod
    from hands_tpu_torch.models.registry import init_weights_
    from hands_tpu_torch.ops import attention as at

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        bb = vit_mod.ViTBackbone(VIT, dtype=torch.float32, fused_attn=True,
                                 device=dev)
        init_weights_(bb, torch.Generator(device=dev).manual_seed(SEED))
        imgs = torch.randn((BATCH, 256, 192, 3), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 8))
        depth = len(bb.blocks)

        def twin():
            with mock.patch.object(vit_mod, "mha_fused", at.mha_plain):
                return bb(imgs)

        with torch.inference_mode():
            bb(imgs)
            reset_launch_counts()
            feat = bb(imgs)
            torch.cuda.synchronize()
            counts = launch_counts()
            check_launches("f32 fused_attn backbone (K7 f32)", counts,
                           {"mha_fused_f32": depth}, 1)
            rows["mha_fused_f32"]["launches"] = counts["mha_fused_f32"]
            require(feat.shape == (BATCH, 16, 12, C)
                    and bool(torch.isfinite(feat).all()),
                    "K7 f32 backbone output")
            compare("f32 fused_attn backbone vs twin", feat, twin(),
                    rel=F32_BACKBONE_REL, mean=F32_BACKBONE_MEAN)
            t = [cuda_ms(twin, iters=3), cuda_ms(lambda: bb(imgs), iters=3),
                 cuda_ms(lambda: bb(imgs), iters=3), cuda_ms(twin, iters=3)]
        print(f"  f32 fused_attn ViT-H backbone forward, {BATCH} crops: "
              f"kernel {min(t[1], t[2]):.3f} ms, twin {min(t[0], t[3]):.3f} "
              f"ms {tag}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
    del bb
    torch.cuda.empty_cache()


def share_check(name, got, ref, mean) -> None:
    """Phase 9's whole-block bound without its largest-error term: at most
    1e-4 of the outputs past BLOCK_REL relative to max(|ref|, 1), and the
    mean |d| within ``mean``."""
    err = (got.float() - ref.float()).abs()
    rel = err / ref.float().abs().clamp(min=1.0)
    share, avg = float((rel > BLOCK_REL).float().mean()), float(err.mean())
    ok = bool(torch.isfinite(got).all()) and share <= 1e-4 and avg <= mean
    print(f"  {name:<34s} share beyond {BLOCK_REL:g} {share:.2e} (<= 0.0001, "
          f"{int((rel > BLOCK_REL).sum())} of {rel.numel()}), max "
          f"{float(rel.max()):.3e}, mean|d| {avg:.3e} (<= {mean:.3e})  "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernels disagree with the twin")


def cast_flip_witness(got, ref, qkv, inv) -> None:
    """Where the block's kernels are farthest from the twin: the entries of
    that token's attention output (the bare cast of o * inv) where the kernel
    and the twin differ, with o * inv computed in f64. A flip whose f64 value
    lies within f32 rounding of an integer is the order of sums, not a
    fault."""
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block as vb

    rel = (got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)
    w = int(rel.argmax())
    n_tok, c = got.shape[1], got.shape[2]
    b, n = w // (n_tok * c), (w // c) % n_tok
    ka = abl.attention_ablation(qkv, HEADS, inv, "cast")[b, n]
    ta = abl.attention_ablation_plain(qkv, HEADS, inv, "cast")[b, n]
    d = qkv.shape[-1] // 3 // HEADS
    t = qkv[b].view(n_tok, 3, HEADS, d)
    q = (t[n, 0] * vb.bf16_const(d**-0.5)).double()  # (H, D)
    s = torch.einsum("hd,mhd->hm", q, t[:, 1].double())
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).double()
    o = torch.einsum("hm,mhd->hd", p, t[:, 2].double()).reshape(-1)
    o = o * inv.double()
    flips = torch.nonzero(ka != ta).flatten().tolist()
    print(f"    worst output {float(rel.flatten()[w]):.3e} at crop {b} token "
          f"{n}; its attention row has {len(flips)} bare cast(s) where kernel "
          f"and twin differ" + "".join(
              f"; channel {i}: kernel {int(ka[i])}, twin {int(ta[i])}, f64 "
              f"o*inv {float(o[i]):.7f}" for i in flips[:4]))


def twin_memory(fn) -> float:
    """Peak device memory (GB) that one call of ``fn`` adds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return (peak - base) / 1e9


def counted_modules():
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8

    return vb, v8, at, mano_lbs, rasterizer, abl


def launch_counts() -> dict:
    vb, *others = counted_modules()
    out = {f"vit_{k}": v for k, v in vb.launches.items()}
    out.update(vb.bwd_launches)
    for mod in others:
        out.update(mod.launches)
    return out


def reset_launch_counts() -> None:
    for mod in counted_modules():
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


def geometry_twins():
    """Every geometry kernel of the models swapped for its plain twin."""
    from hands_tpu_torch.ops import mano as manolib
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        manolib, "lbs_apply", mano_lbs.lbs_apply_plain))
    stack.enter_context(mock.patch.object(
        rasterizer, "splat_silhouette_fused",
        rasterizer.splat_silhouette_plain))
    return stack


def serve_rate(batches, cfg, model, dev):
    """(crops/s, ms/request) of one pass over ``batches`` after a warm-up
    pass, on the host's clock around a synchronise."""
    from hands_tpu_torch.cli.demo import serve

    def run():
        for recs in batches:
            serve(recs, cfg, model, dev)
        torch.cuda.synchronize()
    run()
    t = time.perf_counter()
    run()
    dt = time.perf_counter() - t
    n = sum(len(r) for r in batches)
    return 2 * n / dt, dt / len(batches) * 1e3


def wildhands_phases(rows, dev, tag) -> None:
    """WildHands (``hands_light``) at full width through the entry points:
    serving (f32, bf16, int8 convolutions), the evaluation forward with the
    render and the grasp classifier on, and that forward differentiated."""
    from hands_tpu_torch.cli.demo import serve, serving_config
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.registry import fetch_model, inference_pose
    from hands_tpu_torch.ops import quant
    from hands_tpu_torch.ops import rasterizer

    print(f"phase 5: WildHands, {WH_BACKBONE} x 2, 224^2 crops {tag}")
    requests = {bs: make_requests(n, bs, SEED + 100 + bs)
                for bs, n in WH_BATCHES}
    big = WH_BATCHES[-1][0]

    # ---- serving: render and grasp off, K1 twice per request
    t0 = time.time()
    configs = {}
    for name, kw in (("f32", dict(dtype="float32")),
                     ("bf16", dict(dtype="bfloat16")),
                     ("bf16 quant_int8", dict(dtype="bfloat16",
                                              quant_int8=True))):
        cfg = serving_config("hands_light", **kw).replace(backbone=WH_BACKBONE)
        configs[name] = (cfg, fetch_model(cfg, device=dev, seed=SEED))
    print(f"  three hands_light models built in {time.time() - t0:.1f} s")
    served = {}
    for name, (cfg, model) in configs.items():
        for bs, n in WH_BATCHES:
            if "int8" in name and bs != big:
                continue
            batches = requests[bs]
            serve(batches[0], cfg, model, dev)  # warm-up
            reset_launch_counts()
            outs = [serve(recs, cfg, model, dev) for recs in batches]
            torch.cuda.synchronize()
            counts = launch_counts()
            check_launches(f"hands_light serve {name} bs{bs}", counts,
                           {"lbs_apply": 2}, n)
            rows["lbs_apply"]["launches"] = counts["lbs_apply"]
            check_outputs(outs, bs)
            with geometry_twins():
                ref = serve(batches[0], cfg, model, dev)
            for side in ("r", "l"):
                key = f"pred.mano.vertices.{side}"
                compare_abs(f"serve {name} bs{bs} vertices.{side}",
                            outs[0][key], ref[key], LBS_ABS)
            served[name, bs] = outs[0]
            k_rate, k_ms = serve_rate(batches, cfg, model, dev)
            with geometry_twins():
                t_rate, t_ms = serve_rate(batches, cfg, model, dev)
            k_rate2, k_ms2 = serve_rate(batches, cfg, model, dev)
            print(f"  hands_light {name}: serve bs{bs} ({2 * bs} crops/"
                  f"request): kernels {max(k_rate, k_rate2):.1f} crops/s "
                  f"({min(k_ms, k_ms2):.2f} ms/request), twin {t_rate:.1f} "
                  f"crops/s ({t_ms:.2f} ms/request) {tag}")
    # the model forward alone, on a preprocessed batch already on the card
    for name, (cfg, model) in configs.items():
        for bs, _ in WH_BATCHES:
            pre = DevicePreprocessor(cfg, is_train=False, device=dev)
            inputs, _, meta = pre(stack_records(requests[bs][0]))
            with torch.inference_mode():
                ms = min(cuda_ms(lambda: model(inputs, meta), iters=5)
                         for _ in range(2))
            print(f"  hands_light {name}: model forward bs{bs} ({2 * bs} "
                  f"crops + {bs} images): {ms:.3f} ms {tag}")
    base = served["f32", big]["pred.mano.vertices.r"]
    for name in ("bf16", "bf16 quant_int8"):
        d = (served[name, big]["pred.mano.vertices.r"] - base).abs()
        print(f"  drift of {name} serving against f32, vertices.r: max "
              f"{float(d.max()):.3e} mean {float(d.mean()):.3e} m (random "
              f"weights: a sanity number)")

    # the int8 convolution's integer sums on the card against the CPU's
    gen = torch.Generator().manual_seed(SEED)
    for k, stride, pad in ((3, 2, 1), (1, 2, 0), (3, 1, 1)):
        xq = torch.randint(-127, 128, (3, 24, 9, 9), generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (20, 24, k, k), generator=gen,
                           dtype=torch.int8)
        got = quant._int_conv(xq.to(dev), wq.to(dev), stride, pad).cpu()
        want = quant._int_conv(xq, wq, stride, pad)
        require(bool((got.double() == want).all()),
                f"int8 convolution {k}x{k} stride {stride}: sums differ")
    print("  int8 convolution sums (unfold + _int_mm) equal the CPU's: ok")

    # ---- evaluation forward: the config's defaults, render and grasp on
    cfg = default_config("hands_light", backbone=WH_BACKBONE)
    require(cfg.use_render_seg_loss and cfg.use_grasp_loss,
            "the evaluation config renders and classifies grasps")
    model = fetch_model(cfg, device=dev, seed=SEED)
    pre = DevicePreprocessor(cfg, is_train=False, device=dev)
    inputs, _, meta = pre(stack_records(requests[big][0]))
    inference_pose(model, inputs, meta)  # warm-up
    reset_launch_counts()
    out = inference_pose(model, inputs, meta)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(f"hands_light evaluation forward bs{big}", counts,
                   {"lbs_apply": 2, "splat_fwd": 2}, 1)
    rows["splat_fwd"]["launches"] = counts["splat_fwd"]
    check_outputs([out], big)
    for key, shape in (("pred.render.r", (big, 224, 224)),
                       ("pred.render.l", (big, 224, 224)),
                       ("pred.grasp.r", (big, 9)), ("pred.grasp.l", (big, 9))):
        require(out[key].shape == shape
                and bool(torch.isfinite(out[key]).all()), f"{key} output")
    cover = float(out["pred.render.r"].mean())
    require(0.0 <= cover < 1.0, f"render.r covers {cover} of the image")
    with mock.patch.object(rasterizer, "splat_silhouette_fused",
                           rasterizer.splat_silhouette_plain):
        ref = inference_pose(model, inputs, meta)
    with geometry_twins():
        ref_all = inference_pose(model, inputs, meta)
    for side in ("r", "l"):
        key = f"pred.render.{side}"
        compare_abs(f"evaluation render.{side} (K2 vs twin)", out[key],
                    ref[key], MASK_ABS)
        # with K1's twin too the vertices move by f32 ulps, and the splat's
        # cancelling distance carries that into the mask
        compare_abs(f"evaluation render.{side} (K1, K2 vs twins)", out[key],
                    ref_all[key], 2e-3)
    print(f"  render.r covers {cover:.4f} of the image (random weights put "
          f"the hand far from the camera)")
    # the model's render call on hands at arm's length: 4 cm blobs at 0.5 m
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    verts = torch.randn((big, N_VERTS, 3), generator=gen, device=dev) * 0.02
    verts[..., 2] += 0.5
    K = meta["intrinsics"]
    reset_launch_counts()
    with torch.inference_mode():
        mask = rasterizer.render_silhouette(verts, None, K, cfg.img_res)
        with geometry_twins():
            mask_ref = rasterizer.render_silhouette(verts, None, K,
                                                    cfg.img_res)
    check_launches("render_silhouette", launch_counts(), {"splat_fwd": 1}, 1)
    compare_abs(f"render_silhouette bs{big} at 0.5 m (K2 vs twin)", mask,
                mask_ref, MASK_ABS)
    require(0.01 < float(mask.mean()) < 0.9,
            f"the blobs cover {float(mask.mean())} of the image")

    def forward():
        return inference_pose(model, inputs, meta)

    k_ms, k_gb = peak_ms(forward, warmup=3)
    with geometry_twins():
        t_ms, t_gb = peak_ms(forward, warmup=3)
        t_ms2, _ = peak_ms(forward, warmup=3)
    k_ms2, _ = peak_ms(forward, warmup=3)
    print(f"  hands_light evaluation forward bs{big} ({2 * big} crops, render "
          f"and grasp on): kernels {min(k_ms, k_ms2):.2f} ms, peak +{k_gb:.2f} "
          f"GB; twins {min(t_ms, t_ms2):.2f} ms, peak +{t_gb:.2f} GB {tag}")
    busy_line(f"hands_light evaluation forward bs{big}", forward,
              min(k_ms, k_ms2), tag)

    # ---- the same forward differentiated: an L1 mask loss against the
    # pipeline's zero targets, back through K2, K1 and the network
    gpre = DevicePreprocessor(cfg, is_train=False, device=dev)
    ginputs, gtargets, gmeta = gpre(stack_records(requests[WH_BATCHES[0][0]][0]))
    watch = ["net.head_r.hmr_layer.dec.pose_6d.bias",
             "net.head_l.hmr_layer.dec.cam_t_wp.bias",
             "net.head_r.hmr_layer.dec.shape.bias"]
    params = dict(model.named_parameters())

    def mask_loss_grads():
        pred = model(ginputs, gmeta)
        loss = sum((pred[f"render.{s}"] - gtargets[f"render.{s}"]).abs().mean()
                   for s in ("r", "l"))
        return torch.autograd.grad(loss, [params[k] for k in watch])

    mask_loss_grads()  # warm-up
    reset_launch_counts()
    got = mask_loss_grads()
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(f"hands_light mask-loss gradient bs{WH_GRAD_BATCH}", counts,
                   {"lbs_apply": 2, "lbs_apply_bwd": 2, "splat_fwd": 2,
                    "splat_bwd": 2}, 1)
    for k in ("lbs_apply_bwd", "splat_bwd"):
        rows[k]["launches"] = counts[k]
    with geometry_twins():
        want = mask_loss_grads()
    for k, g, w in zip(watch, got, want):
        require(float(w.abs().max()) > 0.0, f"{k}: zero gradient")
        # each vertex gradient agrees to GRAD_RTOL; summed over 778
        # vertices and carried through MANO and the heads: 1e-2 of the
        # largest entry
        compare_abs(f"grad {k[4:]}", g, w, 1e-2 * float(w.abs().max()))
    del model

    # ---- one HaMeR forward with the render and the grasp classifier on
    hcfg = default_config("hamer_light", compute_dtype="bfloat16",
                          fused_block=True)
    require(hcfg.use_render_seg_loss and hcfg.use_grasp_loss, "HaMeR heads")
    hmodel = fetch_model(hcfg, device=dev, seed=SEED, vit_variant=VIT)
    depth = len(hmodel.net.backbone.blocks)
    hpre = DevicePreprocessor(hcfg, is_train=False, device=dev)
    hinputs, _, hmeta = hpre(stack_records(requests[WH_BATCHES[0][0]][0]))
    inference_pose(hmodel, hinputs, hmeta)  # warm-up
    reset_launch_counts()
    hout = inference_pose(hmodel, hinputs, hmeta)
    torch.cuda.synchronize()
    check_launches("hamer_light evaluation forward", launch_counts(), {
        "vit_layernorm": 2 * depth, "vit_gemm": 4 * depth,
        "vit_attention": depth, "lbs_apply": 2, "splat_fwd": 2}, 1)
    with mock.patch.object(rasterizer, "splat_silhouette_fused",
                           rasterizer.splat_silhouette_plain):
        href = inference_pose(hmodel, hinputs, hmeta)
    for side in ("r", "l"):
        require(hout[f"pred.grasp.{side}"].shape == (WH_BATCHES[0][0], 9),
                "HaMeR grasp output")
        compare_abs(f"hamer_light render.{side} (K2 vs twin)",
                    hout[f"pred.render.{side}"], href[f"pred.render.{side}"],
                    MASK_ABS)
    del hmodel

    # ---- the same paths at a small size against the CPU twins
    small_req = make_requests(1, 2, SEED + 1)[0]
    for name, kw in (("serve f32", dict(use_render_seg_loss=False,
                                        use_grasp_loss=False)),
                     ("evaluation f32", dict())):
        scfg = default_config("hands_light", backbone="resnet18",
                              compute_dtype="float32", **kw)
        small_cpu = fetch_model(scfg, device="cpu", seed=SEED)
        small_gpu = copy.deepcopy(small_cpu).to(dev)
        got = serve(small_req, scfg, small_gpu, dev)
        want = serve(small_req, scfg, small_cpu, "cpu")
        keys = ["pred.mano.vertices.r", "pred.mano.j3d.cam.l"]
        if "evaluation" in name:
            keys += ["pred.grasp.r"]
        for key in keys:
            compare(f"resnet18 {name} GPU vs CPU {key[5:]}", got[key].cpu(),
                    want[key], rel=1e-4, mean=1e-4)
        if "evaluation" in name:
            # the splat amplifies f32 ulps of the vertices (see above)
            compare_abs(f"resnet18 {name} GPU vs CPU render.r",
                        got["pred.render.r"].cpu(), want["pred.render.r"],
                        2e-3)


def device_busy_ms(fn, names=("splat",)):
    """(ms, {name: ms}): the device time of the kernels one call of ``fn``
    launches (torch.profiler over CUPTI, after a warm-up call), and the part
    of it in kernels whose name holds each of ``names``; (None, {}) where
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [(e.key, e.self_device_time_total / 1e3)
             for e in prof.key_averages()]
    total = sum(t for _, t in times)
    if total <= 0.0:
        return None, {}
    return total, {n: sum(t for k, t in times if n in k) for n in names}


def busy_line(what, fn, wall_ms, tag) -> None:
    """Print the device time of one call of ``fn`` beside its wall time."""
    busy, part = device_busy_ms(fn)
    if busy is None:
        print(f"  {what}: device time not measured (the profiler saw none)")
        return
    print(f"  {what}: device busy {busy:.2f} ms of {wall_ms:.2f} ms "
          f"({1.0 - busy / wall_ms:.1%} idle), of it in the splat kernels "
          f"{part['splat']:.3f} ms {tag}")


def peak_ms(fn, iters: int = 5, warmup: int = 1):
    """(ms per call, GB that a call adds at its peak to what is allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(fn, iters=iters, warmup=warmup)
    return ms, (torch.cuda.max_memory_allocated() - base) / 1e9


def block_f64(x, p, num_heads):
    """The bf16 block's function in f64 with no rounding at all, on the
    values the bf16 routes compute with (``p``: the bf16 casts of the
    masters and the f32 LayerNorm parameters, as f64) and the bf16 attention
    scale, exact GELU: the reference of both routes' gradients."""
    from hands_tpu_torch.ops import vit_block as vb

    B, N, Cx = x.shape
    D = Cx // num_heads
    x2 = x.reshape(B * N, Cx)

    def ln(t, s, b):
        mu = t.mean(-1, keepdim=True)
        var = (t * t).mean(-1, keepdim=True) - mu * mu
        return (t - mu) * (torch.rsqrt(var.clamp(min=0.0) + 1e-6) * s) + b

    def dense(t, k):
        return t @ p["w" + k].t() + p["b" + k]

    t = dense(ln(x2, p["ln1_scale"], p["ln1_bias"]), "qkv").view(
        B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    a = torch.softmax((t[0] * vb.bf16_const(D**-0.5))
                      @ t[1].transpose(-1, -2), dim=-1)
    x1 = x2 + dense((a @ t[2]).permute(0, 2, 1, 3).reshape(B * N, Cx),
                    "proj")
    u = dense(ln(x1, p["ln2_scale"], p["ln2_bias"]), "1")
    h = 0.5 * u * torch.special.erfc(-u * 2.0**-0.5)
    return (x1 + dense(h, "2")).view(B, N, Cx)


def k4_leaves(x, p32):
    """Fresh leaves: (x, {name: parameter}, [x, parameters in order])."""
    from hands_tpu_torch.ops import vit_block as vb

    xs = x.detach().clone().requires_grad_(True)
    ps = {k: v.detach().clone().requires_grad_(True) for k, v in p32.items()}
    return xs, ps, [xs] + [ps[k] for k in vb.PARAM_ORDER]


def k4_routes():
    """(K4, the twin) as functions of (x, f32 masters)."""
    from hands_tpu_torch.ops import vit_block as vb

    def k4(xs, ps):
        return vb.vit_block_fused_trainable(xs, ps, HEADS)

    def plain(xs, ps):
        return vb.vit_block_plain(xs, vb._cast_params(ps), HEADS)

    return k4, plain


def k4_backward_ms(x, p32, g, tag) -> dict:
    """K4's forward and backward on one block at the rows of ``x``, read in
    turns: the backward alone (its forward kept), and what the backward ran
    before its kernels (the twin's forward kept for autograd, then its
    backward), each read twice in the order a b b a. Uses only what the
    port has had since K4, so it times an older tree too."""
    k4, plain = k4_routes()

    def bwd_only():
        xs, ps, lv = k4_leaves(x, p32)
        out = k4(xs, ps)
        return lambda: torch.autograd.grad(out, lv, g, retain_graph=True)

    def twin_recompute():
        xs, ps, lv = k4_leaves(x, p32)
        return lambda: torch.autograd.grad(plain(xs, ps), lv, g)

    with torch.no_grad():
        fwd = min(cuda_ms(lambda: k4(x, p32)) for _ in range(2))
    makers = {"k4": bwd_only, "twin": twin_recompute}
    reads = {k: [] for k in makers}
    for name in ("k4", "twin", "twin", "k4"):
        reads[name].append(cuda_ms(makers[name](), iters=5))
    out = {"forward": fwd, "backward": min(reads["k4"]),
           "twin recompute + backward": min(reads["twin"])}
    print(f"  K4 at {x.shape[0] * N_TOK} rows: forward {fwd:.4f} ms, "
          f"backward {reads['k4'][0]:.4f} / {reads['k4'][1]:.4f} ms, the "
          f"twin's forward kept for autograd + its backward "
          f"{reads['twin'][0]:.4f} / {reads['twin'][1]:.4f} ms {tag}")
    return out


def device_account(fn, groups, calls: int = 3):
    """Device ms a call of ``fn`` by kernel (``torch.profiler``, after a
    warm-up call): each kernel goes to the first of ``groups`` ((label,
    name substrings), ...) whose substring its name holds, else to
    "other". Returns ({label: ms}, {label: [(ms, name), ...]}), or None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [(e.key, e.self_device_time_total / 1e3 / calls)
             for e in prof.key_averages()]
    if sum(t for _, t in times) <= 0.0:
        return None
    labels = [label for label, _ in groups] + ["other"]
    ms = {label: 0.0 for label in labels}
    names = {label: [] for label in labels}
    for key, t in times:
        label = next((lab for lab, subs in groups
                      if any(sub in key for sub in subs)), "other")
        ms[label] += t
        names[label].append((t, key))
    return ms, names


def k4_backward_account(x, p32, g, wall_ms, tag) -> None:
    """K4's backward on one block by kernel (:data:`K4_ACCOUNT`): the
    recompute, the three backward kernels, the products, the bias sums, the
    casts and the rest, beside its events reading ``wall_ms``."""
    k4, _ = k4_routes()
    xs, ps, lv = k4_leaves(x, p32)
    out = k4(xs, ps)
    got = device_account(
        lambda: torch.autograd.grad(out, lv, g, retain_graph=True),
        K4_ACCOUNT)
    if got is None:
        print("  K4 backward by kernel: not measured (the profiler saw no "
              "device time)")
        return
    ms, names = got
    busy = sum(ms.values())
    print(f"  K4 backward at {x.shape[0] * N_TOK} rows by kernel, device ms "
          f"a block: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; device {busy:.4f} of {wall_ms:.4f} ms by events {tag}")
    for label in ("products", "casts", "other"):
        top = sorted(names[label], reverse=True)[:4]
        if top:
            print(f"    {label}: " + "; ".join(
                f"{t:.4f} {k[:70]}" for t, k in top))


def trainable_block_phase(rows, x, p32, tag) -> None:
    """K4, ``vit_block_fused_trainable``, at ViT-H shapes: the forward (the
    bf16 block's kernels) against the twin; the backward's launches; the
    gradients of the Function (its backward on the kernels) against
    autograd of the twin for x and each of the twelve f32 master
    parameters, the backward on the twins' pieces against the same, and
    both routes against autograd of the block in f64; the time and peak
    memory of forward and backward beside the plain block's; then the three
    backward kernels against their twins at the train step's 12,288 rows
    and at ragged shapes, and their times."""
    from hands_tpu_torch.ops import vit_block as vb

    print(f"phase 6: K4 vit_block_fused_trainable, rows={ROWS} C={C} "
          f"hidden={HIDDEN}, f32 master parameters {tag}")
    gen = torch.Generator(device=x.device).manual_seed(SEED + 4)
    g = (torch.randn(x.shape, generator=gen, device=x.device) * 0.1).to(
        torch.bfloat16)
    names = ["x"] + list(vb.PARAM_ORDER)
    k4, plain = k4_routes()

    reset_launch_counts()
    xs, ps, lv = k4_leaves(x, p32)
    out = k4(xs, ps)
    counts = launch_counts()
    check_launches("K4 forward", counts, K4_FWD_LAUNCHES, 1)
    saved = out.grad_fn.saved_tensors
    require(len(saved) == 13 and saved[0].data_ptr() == xs.data_ptr()
            and all(t.data_ptr() == ps[k].data_ptr()
                    for t, k in zip(saved[1:], vb.PARAM_ORDER)),
            "K4 saves only x and the parameters")
    xt, pt, lt = k4_leaves(x, p32)
    ref = plain(xt, pt)
    fwd_err = compare("K4 forward vs twin", out.detach(), ref.detach(),
                      rel=BLOCK_REL)
    reset_launch_counts()
    got = torch.autograd.grad(out, lv, g)
    torch.cuda.synchronize()
    check_launches("K4 backward", launch_counts(), K4_BWD_LAUNCHES, 1)
    want = torch.autograd.grad(ref, lt, g)
    twin_route = vb.vit_block_backward(x, p32, g, HEADS, f=vb.PLAIN)
    xf, pf, lf = k4_leaves(x.double(), {
        k: v.double() for k, v in vb._cast_params(p32).items()})
    f64 = torch.autograd.grad(block_f64(xf, pf, HEADS), lf, g.double())
    worst, worst_twin, ratio = 0.0, 0.0, 0.0
    for name, a, b, t, r in zip(names, got, want, twin_route, f64):
        require(a.dtype == b.dtype == t.dtype and a.shape == b.shape
                and (name == "x" or a.dtype == torch.float32),
                f"K4 gradient of {name}: dtype or shape")
        scale = float(b.float().abs().max())
        rel = float((t.float() - b.float()).abs().max()) / scale
        require(scale > 0 and rel <= K4_GRAD_REL,
                f"K4 twin route: gradient of {name} differs from autograd "
                f"of the twin by {rel}")
        worst_twin = max(worst_twin, rel)
        worst = max(worst, compare_grad(f"K4 gradient of {name}", a, b)
                    / scale)
        # mean |d| against the f64 gradient, over its largest entry
        r_scale = float(r.abs().max())
        e_k = float((a.double() - r).abs().mean()) / r_scale
        e_t = float((b.double() - r).abs().mean()) / r_scale
        ratio = max(ratio, e_k / e_t)
        print(f"    against f64 (mean|d|/max|f64|): kernels {e_k:.3e}, "
              f"twin {e_t:.3e}, ratio {e_k / e_t:.3f} (<= {K4_F64_RATIO})")
        require(e_k <= K4_F64_RATIO * e_t,
                f"K4 gradient of {name}: {e_k / e_t:.3f} times the twin's "
                f"distance from the f64 gradient")
    print(f"  K4 gradients of x and 12 parameters: kernels vs autograd of "
          f"the twin max|d| / max|ref| {worst:.3e} (<= {K4_GRAD_MAX:g}); the "
          f"backward on the twins' pieces vs the same {worst_twin:.3e} (<= "
          f"{K4_GRAD_REL:g}); kernels' mean distance from f64 at most "
          f"{ratio:.3f} x the twin's; f32 masters get f32 gradients, 13 "
          f"tensors saved: ok")
    del out, ref, got, want, twin_route, f64, saved, xf, pf, lf

    # times: forward without a graph, forward kept for backward + backward
    def fwd_bwd(fn):
        xs, ps, lv = k4_leaves(x, p32)
        torch.autograd.grad(fn(xs, ps), lv, g)

    def bwd_only(fn):
        xs, ps, lv = k4_leaves(x, p32)
        out = fn(xs, ps)
        return lambda: torch.autograd.grad(out, lv, g, retain_graph=True)

    with torch.no_grad():
        f_plain = min(cuda_ms(lambda: plain(x, p32)) for _ in range(2))
    fb_plain, gb_plain = peak_ms(lambda: fwd_bwd(plain))
    fb_k4, gb_k4 = peak_ms(lambda: fwd_bwd(k4))
    k4_ms = k4_backward_ms(x, p32, g, tag)
    b_plain = min(cuda_ms(bwd_only(plain), iters=5) for _ in range(2))

    def kept(fn):
        """GB a forward holds for its backward, beyond leaves and output."""
        xs, ps, _ = k4_leaves(x, p32)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        out = fn(xs, ps)
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated() - base
                - out.numel() * out.element_size()) / 1e9

    kept_k4, kept_plain = kept(k4), kept(plain)
    prod_ops = 2 * ROWS * C * (3 * C + C + 2 * HIDDEN)
    attn_ops = 4 * BATCH * HEADS * N_TOK * N_TOK * HEAD_DIM
    n_param = sum(v.numel() for v in p32.values())
    # backward: x, g and the f32 parameters read, dx and f32 gradients
    # written; the recompute and the two products of each backward GEMM
    b_bytes = (3 * x.numel() * 2 + 2 * 4 * n_param) / HBM_BYTES_S * 1e3
    b_ops = 3 * (prod_ops + attn_ops) / PEAK_OPS_S["bf16"] * 1e3
    f_bound = sum(rows[k]["bound_ms"] for k in
                  ("vit_layernorm", "vit_gemm", "vit_attention"))
    print(f"  K4 forward {k4_ms['forward']:.4f} ms (twin forward "
          f"{f_plain:.4f} ms, bound {f_bound:.4f} ms); K4 backward "
          f"{k4_ms['backward']:.4f} ms (the parent's design, the twin's "
          f"forward kept for autograd and its backward, "
          f"{k4_ms['twin recompute + backward']:.4f} ms; the twin's "
          f"backward alone {b_plain:.4f} ms; bound "
          f"{max(b_bytes, b_ops):.4f} ms by "
          f"{'operations' if b_ops > b_bytes else 'bytes'}) {tag}")
    print(f"  forward + backward: K4 {fb_k4:.4f} ms, peak +{gb_k4:.3f} GB; "
          f"plain block {fb_plain:.4f} ms, peak +{gb_plain:.3f} GB; held "
          f"between forward and backward beyond leaves and output: K4 "
          f"{kept_k4:.3f} GB, plain block {kept_plain:.3f} GB {tag}")
    require(kept_k4 < 0.25 * kept_plain,
            "K4 holds activations between forward and backward")
    rows["vit_block_fused_trainable"] = {
        "name": "vit_block_fused_trainable", "route": "cuda",
        "source": SRC_K3, "replaces": K4, "launches": 0,
        "max_abs_err": fwd_err, "ms": k4_ms["forward"], "plain_ms": f_plain,
        "bound_ms": f_bound, "bound_by": "operations", "library_ms": None,
        # the backward: K3's kernels recompute, the products, the backward
        # kernels (their own lines), timed beside the twin's backward
        "grad_max_rel_err": worst, "backward_ms": k4_ms["backward"],
        "backward_plain_ms": b_plain,
        "backward_recompute_plain_ms": k4_ms["twin recompute + backward"],
        "backward_library_ms": None,
        "backward_bound_ms": max(b_bytes, b_ops),
        "backward_bound_by": "operations" if b_ops > b_bytes else "bytes"}

    # the backward kernels at the train step's shape: 64 crops a block
    batch = 2 * TRAIN_VIT_BATCH
    print(f"  K4's backward kernels at {batch * N_TOK} rows ({batch} crops, "
          f"the HaMeR bs{TRAIN_VIT_BATCH} step's block)")
    xb, pb, _ = block_inputs(gen, x.device, batch, N_TOK, C, HIDDEN)
    groups, extra = bwd_cases(xb, pb, gen)
    check_groups(groups, {}, rows)
    check_extra(extra)
    bwd_ragged_check(gen, x.device)
    time_groups(groups, rows, tag, earlier=False)
    time_extra(extra, tag)
    for k in BWD_KERNELS:
        rows[k]["rows"] = batch * N_TOK


def k8_row_cases(x2, ln_s, ln_b, oh, qkv3, inv, heads, exact=True):
    """K8's LayerNorm knock-outs and bare cast on token rows ``x2``, its
    merge of the attention's f32 heads ``oh`` (B*H, N, D) back to tokens and
    its quantised q third of ``qkv3`` (B, N, 3C), in the format of
    :func:`kernel_cases`' dicts, bit-equal to their twins and timed through
    a CUDA graph, each of the last three beside a yardstick that moves the
    same bytes (``permute().contiguous()``, ``.to(torch.int8)``: no
    quantisation, and ``to`` wraps where the bare cast saturates);
    ``exact=False`` holds ``ln_cast`` within one int8 step (a design from
    before its twin's sum order)."""
    from hands_tpu_torch.ops import vit_block_ablation as abl

    rows_n, c = x2.shape
    g, n, d = oh.shape

    def case(label, call, inputs, ops, yardstick=None, check=compare_equal):
        return [Case(label, call, inputs, ops, "f32", check=check,
                     timer=short_ms, yardstick=yardstick)]

    return {
        "ln_affine_quant": (abl.ln_ablation, abl.ln_ablation_plain, case(
            "no_ln: x*s+b, quantise",
            lambda f: f(x2, ln_s, ln_b, True, False), [x2, ln_s, ln_b],
            3 * rows_n * c)),
        "ln_cast": (abl.ln_ablation, abl.ln_ablation_plain, case(
            "no_quant: LayerNorm, bare cast",
            lambda f: f(x2, ln_s, ln_b, False, True), [x2, ln_s, ln_b],
            8 * rows_n * c,
            check=compare_equal if exact else compare_int8)),
        "heads_merge_quant": (abl.heads_merge_quant,
                              abl.heads_merge_quant_plain, case(
            "attn_merged: heads back, quantise",
            lambda f: f(oh, inv, heads), [oh, inv], 2 * oh.numel(),
            ("permute().contiguous()", lambda: oh.view(
                g // heads, heads, n, d).permute(0, 2, 1, 3).contiguous()))),
        "cast_rows": (abl.cast_rows, abl.cast_rows_plain, case(
            "mm_only: bare cast of the tokens", lambda f: f(x2), [x2],
            rows_n * c, ("x.to(torch.int8)", lambda: x2.to(torch.int8)))),
        "qslice_quant": (abl.qslice_quant, abl.qslice_quant_plain, case(
            "no_attn: q third, quantise", lambda f: f(qkv3, inv),
            [qkv3[..., :c], inv], 2 * rows_n * c,
            ("qkv[..., :C].to(torch.int8)",
             lambda: qkv3[..., :c].to(torch.int8)))),
    }


def ablation_cases(x, op):
    """K8's own kernels at the shapes the ablation probe gives them, in the
    format of :func:`kernel_cases`; the inputs of each are the twin's
    intermediates of the mode that launches it."""
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8

    B, N, c = x.shape
    rows_n, hidden = B * N, op["w1_q"].shape[0]
    x2 = x.reshape(rows_n, c)
    inv = op["inv_proj"]
    qy, _ = v8.ln_quant_plain(x2, op["ln1_s"], op["ln1_b"], False)
    qkv = v8.gemm_i8_plain(qy, op["wqkv_q"], op["dqkv"], op["bqkv"])
    qkv3 = qkv.view(B, N, 3 * c)
    qo = at.qkv_attention_plain(qkv3, HEADS, inv).view(rows_n, c)
    x1 = v8.gemm_i8_plain(qo, op["wproj_q"], op["dproj"], op["bproj"],
                          epilogue="residual", residual=x2)
    qy2, _ = v8.ln_quant_plain(x1, op["ln2_s"], op["ln2_b"], False)
    qx = abl.cast_rows_plain(x2)
    qkvh = abl.heads_split_plain(qkv3, HEADS).contiguous()
    oh = abl.attention_heads_plain(qkvh)
    del x1, qo
    attn_ops = 4 * B * HEADS * N * N * HEAD_DIM
    t5 = qkv3.view(B, N, 3, HEADS, HEAD_DIM).permute(2, 0, 3, 1, 4)

    def sdpa():
        return F.scaled_dot_product_attention(t5[0], t5[1], t5[2])

    def gemm_ops(n, k):
        return 2 * rows_n * n * k

    def int_mm(a_q, w_q):
        return lambda: torch._int_mm(a_q, w_q.t())

    def one(name, kfn, pfn, case):
        return name, (kfn, pfn, [case])

    rowpasses = k8_row_cases(x2, op["ln1_s"], op["ln1_b"], oh, qkv3, inv,
                             HEADS)
    kernels = dict([
        ("ln_affine_quant", rowpasses["ln_affine_quant"]),
        ("ln_cast", rowpasses["ln_cast"]),
        ("cast_rows", rowpasses["cast_rows"]),
        ("qslice_quant", rowpasses["qslice_quant"]),
        one("heads_split", abl.heads_split, abl.heads_split_plain,
            heads_split_case(qkv3, HEADS)),
        ("heads_merge_quant", rowpasses["heads_merge_quant"]),
        one("gemm_i8_gelu_cast", abl.gemm_i8_ablation,
            abl.gemm_i8_ablation_plain, Case(
                "no_quant: mlp1+gelu_tanh, bare cast",
                lambda f: f(qy2, op["w1_q"], op["d1"], op["b1"], "gelu_cast",
                            op["inv_mlp2"], True),
                [qy2, op["w1_q"], op["d1"], op["b1"], op["inv_mlp2"]],
                gemm_ops(hidden, c), "int8", int_mm(qy2, op["w1_q"]),
                compare_gelu_gemm)),
        one("gemm_i8_ident_quant", abl.gemm_i8_ablation,
            abl.gemm_i8_ablation_plain, Case(
                "no_gelu: mlp1, quantise",
                lambda f: f(qy2, op["w1_q"], op["d1"], op["b1"],
                            "ident_quant", op["inv_mlp2"]),
                [qy2, op["w1_q"], op["d1"], op["b1"], op["inv_mlp2"]],
                gemm_ops(hidden, c), "int8", int_mm(qy2, op["w1_q"]),
                compare_equal)),
        one("gemm_i8_cast", abl.gemm_i8_ablation, abl.gemm_i8_ablation_plain,
            Case("mm_only: qkv, bare cast of a third",
                 lambda f: f(qx, op["wqkv_q"], op["dqkv"], op["bqkv"], "cast",
                             keep_cols=c),
                 [qx, op["wqkv_q"], op["dqkv"], op["bqkv"]],
                 gemm_ops(3 * c, c), "int8", int_mm(qx, op["wqkv_q"]),
                 compare_equal)),
        one("attention_cast", abl.attention_ablation,
            abl.attention_ablation_plain, Case(
                "no_quant: attention, bare cast",
                lambda f: f(qkv3, HEADS, inv, "cast"), [qkv3, inv], attn_ops,
                "bf16", sdpa, compare_int8)),
        one("attention_no_softmax", abl.attention_ablation,
            abl.attention_ablation_plain, Case(
                "no_softmax: p = bf16(s * 0.01)",
                lambda f: f(qkv3, HEADS, inv, "no_softmax"), [qkv3, inv],
                attn_ops, "bf16", sdpa, compare_int8)),
        one("attention_heads", abl.attention_heads, abl.attention_heads_plain,
            Case("attn_merged: contiguous heads, f32 out",
                 lambda f: f(qkvh), [qkvh], attn_ops, "bf16",
                 lambda: F.scaled_dot_product_attention(
                     qkvh[0][None], qkvh[1][None], qkvh[2][None]))),
        one("attention_i8", abl.attention_i8, abl.attention_i8_plain, Case(
            "attn_i8: int8 q.k and p.v", lambda f: f(qkv3, HEADS, inv),
            [qkv3, inv], attn_ops, "int8", sdpa, compare_int8)),
    ])
    return [(K8, SRC_ABL, kernels)]


def ablation_phase(rows, dev, tag) -> None:
    """K8: the nine knock-out modes of the static int8 block at ViT-H width,
    256 crops (49,152 token rows), through ``cli.int8_ablation``."""
    from hands_tpu_torch.cli import int8_ablation as cli
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8

    print(f"phase 9: K8, static int8 block ablation, {ABL_BATCH} crops "
          f"({ABL_BATCH * N_TOK} rows), C={C} hidden={HIDDEN} heads={HEADS} "
          f"{tag}")
    t0 = time.time()
    x, op = cli.make_probe(ABL_BATCH, dev, c=C, hidden=HIDDEN, n_tok=N_TOK)
    torch.cuda.synchronize()
    print(f"  probe (RandomState(0), the JAX script's draws) made in "
          f"{time.time() - t0:.1f} s")
    groups = ablation_cases(x, op)
    check_groups(groups, {}, rows)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def kernels(mode, xs=x, ops=op):
        return abl.vit_block_ablation(xs, ops, num_heads=HEADS, mode=mode)

    def twin(mode, xs=x, ops=op):
        return abl.vit_block_ablation_plain(xs, ops, HEADS, mode)

    # every mode against its twin, with its launches counted. Each kernel was
    # held to its twin above on the same inputs, the row passes bit for bit;
    # the attention kernels sum on the tensor cores in another order than
    # their twins, and a value that lands one int8 step apart moves its row
    # of the attention output and reaches the block's output through two
    # more quantisations, on tokens of magnitude 0.5. So the whole block is
    # held to the static block's mean bound, to BLOCK_REL on all but 1e-4 of
    # its 6.3e7 elements, and to 4x BLOCK_REL on every element.
    outs = {}
    for mode in abl.MODES:
        reset_launch_counts()
        outs[mode] = kernels(mode)
        torch.cuda.synchronize()
        check_launches(f"ablation {mode}", launch_counts(),
                       abl.MODE_LAUNCHES[mode], 1)
        ref = twin(mode).float()
        err = (outs[mode].float() - ref).abs()
        rel = err / ref.abs().clamp(min=1.0)
        worst = int(rel.argmax())
        share, avg = float((rel > BLOCK_REL).float().mean()), float(err.mean())
        ok = (bool(torch.isfinite(outs[mode]).all()) and share <= 1e-4
              and avg <= MAX_MEAN and float(rel.max()) <= 4 * BLOCK_REL)
        print(f"  whole block, mode {mode} ({ABL_BATCH} crops): max|d|/max("
              f"|ref|,1) {float(rel.max()):.3e} (<= {4 * BLOCK_REL:g}; kernel "
              f"{float(outs[mode].flatten()[worst]):.4f}, twin "
              f"{float(ref.flatten()[worst]):.4f}), share beyond {BLOCK_REL:g}"
              f" {share:.2e} (<= 0.0001), mean|d| {avg:.3e} (<= {MAX_MEAN:g})  "
              f"{'ok' if ok else 'FAIL'}")
        require(ok, f"ablation mode {mode}: kernels disagree with the twin")
        del ref, err, rel
    static = v8.vit_block_fused_int8_static(x, op, num_heads=HEADS,
                                            fast_gelu=True)
    compare_equal("mode full vs the static block (K6)", outs["full"], static)
    compare_equal("mode attn_merged vs mode full", outs["attn_merged"],
                  outs["full"])
    zero = {m: float((outs[m] == 0).float().mean()) for m in
            ("mm_only", "no_quant")}
    del outs, static
    # the probe's bare casts truncate nearly everything to 0: hold the two
    # modes made of casts also on inputs that spread over the int8 range
    xw, opw = wide_probe(x[:BATCH], op, dev)
    # no_quant's attention sums on the tensor cores, in another order than
    # its twin: on these inputs it is held to its twin within one int8 step
    # (compare_int8), and the mode's bare casts, which this check is for, to
    # the twin path that takes the kernel's attention output; the whole block
    # is also held to the independent twin as above, by the share of its
    # outputs past BLOCK_REL and the mean
    seen = []

    def kernel_attention(qkv, heads, inv, variant):
        seen.append(qkv)
        return abl.attention_ablation(qkv, heads, inv, variant)

    for mode in ("mm_only", "no_quant"):
        got = kernels(mode, xw, opw)
        indep = twin(mode, xw, opw)
        with mock.patch.object(abl._PLAIN, "attn_abl", kernel_attention):
            ref = twin(mode, xw, opw)
        for qkv in seen:
            compare_int8(f"mode {mode}, wide inputs: attention_cast",
                         abl.attention_ablation(qkv, HEADS, opw["inv_proj"],
                                                "cast"),
                         abl.attention_ablation_plain(
                             qkv, HEADS, opw["inv_proj"], "cast"))
        compare(f"mode {mode}, wide inputs ({BATCH} crops)", got, ref,
                rel=BLOCK_REL, mean=MAX_MEAN * float(ref.float().abs().mean()))
        share_check(f"mode {mode}, wide inputs, vs the independent twin", got,
                    indep, MAX_MEAN * float(indep.float().abs().mean()))
        if seen:
            cast_flip_witness(got, indep, seen[0], opw["inv_proj"])
        seen.clear()
        print(f"    of the outputs are 0: probe {zero[mode]:.3f}, wide "
              f"{float((ref == 0).float().mean()):.3f}; |wide| > 127 after "
              f"the first cast's input: "
              f"{float((xw.float().abs() > 127).float().mean()):.3f}")

    # the main path: the entry point's function, counts set to 0 before it
    reset_launch_counts()
    lines = []
    times = cli.run_ablation(ABL_BATCH, ABL_ITERS, abl.MODES, dev,
                             probe=(x, op), heads=HEADS,
                             out=lines.append)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {}
    for mode in abl.MODES:
        for k, n in abl.MODE_LAUNCHES[mode].items():
            want[k] = want.get(k, 0) + n
    check_launches("cli.int8_ablation, nine modes", counts, want,
                   ABL_ITERS + 1)
    for k in groups[0][2]:
        rows[k]["launches"] = counts[k]
    require(set(times) == set(abl.MODES)
            and all(np.isfinite(v) and v > 0 for v in times.values()),
            "ablation times")
    for line in lines:
        print("  " + line + (f" {tag}" if "ms/block" in line else ""))
    int8_ops = 2 * ABL_BATCH * N_TOK * C * (3 * C + C + 2 * HIDDEN)
    floor = int8_ops / PEAK_OPS_S["int8"] * 1e3
    print(f"  int8 bound of the four products: {int8_ops:.3e} operations, "
          f"{floor:.3f} ms; mm_only is {times['mm_only'] / floor:.1f}x that, "
          f"full {times['full'] / floor:.1f}x {tag}")
    ablation_account(kernels, times, tag)
    time_groups(groups, rows, tag)
    del x, op
    torch.cuda.empty_cache()


def wide_probe(x, op, dev):
    """The probe's tokens and operands scaled so that the values meeting
    K8's bare casts spread over the int8 range and past it (on the probe
    they truncate to 0): tokens x 160, biases of std 60, LayerNorm scales
    doubled."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    xw = (x.float() * 160.0).to(torch.bfloat16)
    opw = dict(op)
    for k in ("bqkv", "bproj", "b1", "b2"):
        opw[k] = torch.randn(op[k].shape, generator=gen, device=dev) * 60.0
    for k in ("ln1_s", "ln2_s"):
        opw[k] = op[k] * 2.0
    return xw, opw


def cast_chain_zeros(x, op) -> list:
    """The share of zeros in each int8 operand of ``mm_only``'s four
    products (the bare cast of the tokens, then three GEMMs' bare casts),
    through the kernels."""
    from hands_tpu_torch.ops import vit_block_ablation as abl

    c = x.shape[-1]
    a = abl.cast_rows(x.reshape(-1, c))
    shares = [float((a == 0).float().mean())]
    for w, d, b, keep in (("wqkv_q", "dqkv", "bqkv", c),
                          ("wproj_q", "dproj", "bproj", None),
                          ("w1_q", "d1", "b1", None)):
        a = abl.gemm_i8_ablation(a, op[w], op[d], op[b], "cast",
                                 keep_cols=keep)
        shares.append(float((a == 0).float().mean()))
    return shares


def ablation_account(kernels, times, tag, calls: int = 3,
                     modes=K8_ACCOUNTED) -> None:
    """``full - mode`` of ``modes``, launch by launch: the device time of
    each kernel of :data:`K8_KERNEL_NAMES` in one block (mean of ``calls``,
    ``torch.profiler``), its difference from ``full``, and what the entry
    point's events reading (``times``) leaves over."""
    busy = {}
    for mode in ("full",) + tuple(modes):
        total, part = device_busy_ms(
            lambda m=mode: [kernels(m) for _ in range(calls)],
            K8_KERNEL_NAMES)
        if total is None:
            print("  device time by kernel: not measured (the profiler saw "
                  "none)")
            return
        busy[mode] = {k: v / calls for k, v in part.items()}
        busy[mode]["other"] = total / calls - sum(busy[mode].values())
        print(f"  mode {mode}, device ms a block by kernel: " + ", ".join(
            f"{k} {v:.4f}" for k, v in busy[mode].items() if v) + f" {tag}")
    for mode in modes:
        diff = {k: busy["full"][k] - busy[mode][k] for k in busy["full"]}
        device = sum(diff.values())
        wall = times["full"] - times[mode]
        print(f"  full - {mode}: {wall:+.4f} ms/block = device "
              f"{device:+.4f} (" + ", ".join(
                  f"{k} {v:+.4f}" for k, v in diff.items() if v) +
              f") + left over {wall - device:+.4f} {tag}")


def training_runtime_phase(rows, dev, tag, steps: int = LOOP_STEPS,
                           split_batches: int = 2) -> None:
    """The training runtime through its entry points: ``cli.train`` on
    full-width WildHands (two ResNet-50s, 224^2, bf16, mask and grasp loss
    on) with the synthetic dataset, 64 images a step, train-mode
    preprocessing and the prefetch thread on; ``cli.evaluate`` on the
    checkpoint it wrote; a resumed run; then the same epoch on the packed
    set (:func:`packed_loop_phase`)."""
    import os
    import tempfile

    from hands_tpu_torch.cli import _args
    from hands_tpu_torch.cli import evaluate as cli_evaluate
    from hands_tpu_torch.cli import train as cli_train
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import PrefetchLoader
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step
    from hands_tpu_torch.train.trainer import Trainer

    bs = TRAIN_WH_BATCH
    print(f"phase 10: cli.train / cli.evaluate, WildHands {WH_BACKBONE} x 2, "
          f"{bs} images a step, {steps} steps an epoch, synthetic records "
          f"{tag}")
    common = ["--dataset", "synthetic", "--eval_on", "synthetic",
              "--valsplit", "smallval", "--batch_size", str(bs),
              "--test_batch_size", str(bs), "--num_workers", "8", "--mute",
              "--no_vis"]
    train_args = common + ["--trainsplit", "train", "--eval_every_epoch", "1",
                           "--log_every", "2", "--exp_key", "smoke"]
    cfg, _ = _args.parse(train_args)
    require(cfg.backbone == WH_BACKBONE and cfg.use_render_seg_loss
            and cfg.use_grasp_loss and cfg.compute_dtype == "bfloat16"
            and cfg.img_res == 224, "the full-width default train config")
    trainers = []
    fit = Trainer.fit

    def recording_fit(self, *args, **kwargs):
        trainers.append(self)
        return fit(self, *args, **kwargs)

    def run(extra, root):
        """cli.train with the launch counts set to 0 before it."""
        reset_launch_counts()
        state = cli_train.main(train_args + extra, log_root=root)
        torch.cuda.synchronize()
        return state, launch_counts()

    # sanity validation + the epoch's steps + one validation batch
    def expect(n_steps):
        return {"lbs_apply": 4 * (n_steps + 2), "lbs_apply_bwd": 2 * n_steps,
                "splat_fwd": 2 * (n_steps + 2), "splat_bwd": 2 * n_steps}

    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(
            SyntheticRecordDataset._SPLIT_LEN, {"train": bs * steps}), \
            mock.patch.object(Trainer, "fit", recording_fit):
        root = os.path.join(tmp, "logs")
        t0 = time.time()
        state, counts = run(["--num_epoch", "1"], root)
        first_s = time.time() - t0
        require(state.step == steps and state.tx.count == steps,
                f"cli.train took {state.step} steps, want {steps}")
        check_launches("cli.train, epoch 1", counts, expect(steps), 1)
        exp_dir = os.path.join(root, "smoke")
        ck = os.path.join(exp_dir, "checkpoints")
        require(sorted(os.listdir(ck)) == ["epoch_0000", "last", "scores.json"]
                and os.path.exists(os.path.join(exp_dir, "args.json")),
                f"checkpoints written: {os.listdir(ck)}")
        rows_log = [json.loads(ln) for ln in
                    open(os.path.join(exp_dir, "metrics.jsonl"))]
        train_rows = [r for r in rows_log if "loss__train" in r]
        val_rows = [r for r in rows_log if "loss__val" in r]
        require(len(train_rows) == steps // 2 and len(val_rows) == 1
                and all(np.isfinite(v) for r in rows_log for v in r.values()),
                "metrics.jsonl: windows, one validation, finite values")
        require("loss/mask/r__train" in train_rows[0]
                and "metric.mpjpe/ra/h__val" in val_rows[0],
                "the mask loss and the metrics are logged")
        print(f"  epoch 1 ({first_s:.1f} s with model build and warm-up): "
              f"loss__train windows "
              + ", ".join(f"{r['loss__train']:.2f}" for r in train_rows)
              + f"; loss__val {val_rows[0]['loss__val']:.4f}; checkpoints "
              f"{sorted(os.listdir(ck))}")

        # the checkpoint through cli.evaluate: same weights, same batches
        reset_launch_counts()
        metrics = cli_evaluate.main(
            common + ["--infer_ckpt", os.path.join(ck, "last"), "--exp_key",
                      "evaluate"], log_root=root)
        torch.cuda.synchronize()
        check_launches("cli.evaluate", launch_counts(),
                       {"lbs_apply": 4, "splat_fwd": 2}, 1)
        want = val_rows[0]["loss__val"]
        err = abs(metrics["loss"] - want) / abs(want)
        print(f"  cli.evaluate --infer_ckpt last: loss {metrics['loss']:.6f} "
              f"against the trainer's loss__val {want:.6f}, relative "
              f"{err:.2e} (<= 1e-05)")
        require(err <= 1e-5, "cli.evaluate does not reproduce loss__val")

        # resume: starts at the saved epoch, one more epoch of steps
        state2, counts2 = run(["--num_epoch", "2", "--resume_ckpt",
                               os.path.join(ck, "last")], root)
        require(state2.step == 2 * steps and state2.tx.count == 2 * steps,
                f"the resumed run ended at step {state2.step}")
        check_launches("cli.train, resumed epoch 2", counts2, expect(steps), 1)
        for k in ("lbs_apply", "lbs_apply_bwd", "splat_fwd", "splat_bwd"):
            rows[k]["launches"] = counts2[k]
        require(sorted(os.listdir(root)) == ["evaluate", "smoke"],
                "the resumed run reused its experiment key")
        resumed = trainers[-1]
        timing = resumed.timing
        require(timing["steps"] == steps, "the resumed run's step count")
        loop_ms = timing["loop_s"] / steps * 1e3
        wait = timing["data_s"] / timing["loop_s"]

        # the bare step on one preprocessed batch of the same loader
        model = state2.model
        from hands_tpu_torch.core.xdict import device_view
        from hands_tpu_torch.data.factory import fetch_dataloader
        train_loader = fetch_dataloader(cfg, "train", device=dev)
        require(isinstance(train_loader, PrefetchLoader),
                "the train loader prefetches")
        inputs, targets, meta = train_loader.peek()
        batch = (inputs, targets, device_view(meta))
        bare_state = create_train_state(cfg, model)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step = make_train_step(model, cfg)
        bare_ms, _ = steps_ms(step, bare_state, batch, n=3, gen=gen)
        # the loader alone: host fetch + stack + pin + copy + preprocessing
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in train_loader)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) / n_batches * 1e3
        print(f"  training loop (resumed epoch, {steps} steps): {loop_ms:.1f} "
              f"ms a step, {1e3 / loop_ms:.2f} steps/s, "
              f"{bs * 1e3 / loop_ms:.1f} images/s; the bare step on a batch "
              f"on the card {bare_ms:.1f} ms, {1e3 / bare_ms:.2f} steps/s, "
              f"{bs * 1e3 / bare_ms:.1f} images/s; the loop waits for the "
              f"loader {100 * wait:.1f}% of its time; the loader alone (8 "
              f"fetch threads, prefetch on, train-mode preprocessing) "
              f"{load_ms:.1f} ms a batch {tag}")
        packed_loop_phase(cfg, model, train_loader.loader, root,
                          expect(steps), (loop_ms, bare_ms, wait),
                          split_batches, tag)


def loader_split(loader, n_batches: int, tag: str) -> dict:
    """Where a batch of ``loader`` (a ``DeviceDataLoader``) goes, ms a batch
    over ``n_batches`` of one epoch's order: the fetch (``dataset[i]`` for
    each record, sequentially, or one ``stacked_batch``), ``stack_records``
    (none on the packed path), the pinning (host clock) and the device half
    ``device_batch`` (copy and preprocessing launches, by CUDA events); then
    each half of the loader on its own: the host half (``host_batches``,
    with its fetch threads) and the device half on the batches it made."""
    from hands_tpu_torch.data.device_pipeline import pin_batch, stack_records

    ds, bs = loader.dataset, loader.batch_size
    packed = hasattr(ds, "stacked_batch")
    order, gen = loader.begin_epoch()
    parts = {k: [] for k in ("fetch", "stack_records", "pinning",
                             "device_batch")}
    for b in range(n_batches):
        idxs = order[b * bs:(b + 1) * bs]
        t0 = time.perf_counter()
        if packed:
            stacked = ds.stacked_batch(idxs)
            t1 = time.perf_counter()
        else:
            recs = [ds[int(i)] for i in idxs]
            t1 = time.perf_counter()
            stacked = stack_records(recs)
        t2 = time.perf_counter()
        pinned = pin_batch(stacked)
        t3 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loader.device_batch(pinned, len(idxs), gen)
        end.record()
        end.synchronize()
        for k, v in (("fetch", t1 - t0), ("stack_records", t2 - t1),
                     ("pinning", t3 - t2)):
            parts[k].append(v * 1e3)
        parts["device_batch"].append(start.elapsed_time(end))
    # each half of the loader on its own: the host half (with its fetch
    # threads) for n batches, stopped, then the device half on them
    order, gen = loader.begin_epoch()
    host, device, items = [], [], []
    it = loader.host_batches(order)
    for _ in range(n_batches):
        t0 = time.perf_counter()
        items.append(next(it))
        host.append((time.perf_counter() - t0) * 1e3)
    it.close()
    for item in items:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loader.device_batch(*item, gen)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    out = {k: float(np.mean(v)) for k, v in parts.items()}
    out.update(host_half=float(np.mean(host)),
               device_half=float(np.mean(device)))
    name = "packed" if packed else "records"
    print(f"  loader split ({name}, {bs} images a batch, mean of {n_batches} "
          f"batches): fetch {out['fetch']:.2f} ms "
          f"({'one stacked_batch' if packed else 'dataset[i] x ' + str(bs)}),"
          f" stack_records {out['stack_records']:.2f} ms, pinning "
          f"{out['pinning']:.2f} ms, device_batch {out['device_batch']:.2f} "
          f"ms (events); each half on its own: host "
          f"{out['host_half']:.2f} ms, device {out['device_half']:.2f} ms "
          f"{tag}")
    return out


def packed_loop_phase(cfg, model, record_loader, root, expected, phase10,
                      split_batches: int, tag: str) -> None:
    """Phase 10b: the synthetic train set of phase 10 packed through
    ``cli.pack_records`` into ``root/packed``, ``stacked_batch`` held bit for
    bit against ``stack_records`` of the same records, one epoch of
    ``Trainer.fit`` (with validation) on a ``PrefetchLoader`` over the
    packed set with phase 10's launch counts, its loop beside phase 10's,
    and the loader's split for both loaders."""
    import os

    from hands_tpu_torch.cli import pack_records
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import (DeviceDataLoader,
                                                      PrefetchLoader,
                                                      stack_records)
    from hands_tpu_torch.data.factory import fetch_dataloader
    from hands_tpu_torch.data.packed import PackedRecordDataset
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    bs, dev = record_loader.batch_size, record_loader.device
    records = record_loader.dataset
    n = len(records)
    pdir = os.path.join(root, "packed_set")
    t0 = time.time()
    require(pack_records.main(["--synthetic", str(n), "--split", "train",
                               "--out", pdir]) == 0, "cli.pack_records")
    pack_s = time.time() - t0
    packed = PackedRecordDataset(pdir)
    require(len(packed) == n and isinstance(records, SyntheticRecordDataset),
            "the packed set holds phase 10's records")
    idxs = np.random.RandomState(SEED).permutation(n)[:bs]
    direct = stack_records([records[int(i)] for i in idxs])
    fast = packed.stacked_batch(idxs)
    require(set(direct) == set(fast) and all(
        direct[k] == fast[k] if isinstance(direct[k], list)
        else (direct[k].dtype == fast[k].dtype
              and direct[k].tobytes() == fast[k].tobytes())
        for k in direct), "stacked_batch equals stack_records bit for bit")
    size = sum(os.path.getsize(os.path.join(pdir, f))
               for f in os.listdir(pdir))
    print(f"phase 10b: {n} records packed by cli.pack_records in "
          f"{pack_s:.1f} s ({size / 1e6:.1f} MB); stacked_batch of {bs} "
          f"equals stack_records bit for bit")
    inner = DeviceDataLoader(packed, cfg, bs, is_train=True, seed=cfg.seed,
                             device=dev)
    trainer = Trainer(cfg, model, Experiment(cfg.replace(exp_key="packed"),
                                             root=root))
    reset_launch_counts()
    state = trainer.fit(PrefetchLoader(inner),
                        fetch_dataloader(cfg, "val", device=dev),
                        num_epochs=1)
    torch.cuda.synchronize()
    steps = trainer.timing["steps"]
    require(state.step == steps == len(inner), "the packed epoch's steps")
    check_launches("Trainer.fit on the packed set", launch_counts(),
                   expected, 1)
    loop_ms = trainer.timing["loop_s"] / steps * 1e3
    wait = trainer.timing["data_s"] / trainer.timing["loop_s"]
    r_loop, bare_ms, r_wait = phase10
    print(f"  training loop on the packed set ({steps} steps): "
          f"{loop_ms:.1f} ms a step, {bs * 1e3 / loop_ms:.1f} images/s, "
          f"waiting for the loader {100 * wait:.1f}% of it; on the records "
          f"(phase 10) {r_loop:.1f} ms a step, {100 * r_wait:.1f}% waiting; "
          f"the bare step {bare_ms:.1f} ms {tag}")
    loader_split(record_loader, split_batches, tag)
    loader_split(inner, split_batches, tag)


PCL_GEOM = 1e-5  # rotations and angles, as tests/test_torch_pcl.py
PCL_CROP = 2e-4  # the crops on their [0, 1] scale, as there
DECOMPOSE_ITERS = 2  # timed calls a row of the decompositions (were 3)


def pcl_phase(dev, tag) -> None:
    """WildHands (two ResNet-50s, 224^2, bf16) with ``pos_enc="pcl"`` at 64
    images: the preprocessing on the card against the same call on the CPU
    (crops, rotations, angles), its ms beside the default mode's, one
    evaluation forward and one train step on the card."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.registry import fetch_model, inference_pose
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    bs = TRAIN_WH_BATCH
    print(f"phase 11: WildHands {WH_BACKBONE} x 2 with pos_enc=pcl, {bs} "
          f"images {tag}")
    cfg = default_config("hands_light", backbone=WH_BACKBONE, pos_enc="pcl")
    records = SyntheticRecordDataset(cfg, "train", length=bs)
    stacked = stack_records([records[i] for i in range(bs)])
    pre = DevicePreprocessor(cfg, is_train=False, device=dev)
    got = pre(stacked)
    want = DevicePreprocessor(cfg, is_train=False, device="cpu")(stacked)
    mean = torch.tensor(cfg.img_norm_mean)
    std = torch.tensor(cfg.img_norm_std)
    for key in ("r_img", "l_img", "r_rot", "l_rot", "img", "r_center_angle",
                "r_corner_angle"):
        a, b = got[0][key].cpu(), want[0][key]
        if key.endswith("_img"):  # the crops on their [0, 1] scale
            a, b, atol = a * std + mean, b * std + mean, PCL_CROP
        else:
            atol = 2e-4 if key == "img" else PCL_GEOM
        compare_abs(f"pcl preprocessing {key}, card vs CPU", a, b, atol)
    compare_abs("pcl intrinsics, card vs CPU", got[2]["intrinsics"].cpu(),
                want[2]["intrinsics"], 0.0, rtol=1e-6)
    plain = DevicePreprocessor(default_config("hands_light",
                                              backbone=WH_BACKBONE),
                               is_train=False, device=dev)
    # pcl, default, default, pcl: the better of each pair
    t = [cuda_ms(lambda p=p: p(stacked), iters=5)
         for p in (pre, plain, plain, pre)]
    print(f"  eval preprocessing of {bs} records (320 x 427, host arrays in, "
          f"the copy included): pcl {min(t[0], t[3]):.2f} ms, the default "
          f"mode ({plain.cfg.pos_enc}) {min(t[1], t[2]):.2f} ms {tag}")

    model = fetch_model(cfg, device=dev, seed=SEED)
    inputs, targets, meta = got
    inference_pose(model, inputs, meta)  # warm-up
    reset_launch_counts()
    out = inference_pose(model, inputs, meta)
    torch.cuda.synchronize()
    check_launches("hands_light pcl evaluation forward", launch_counts(),
                   {"lbs_apply": 2, "splat_fwd": 2}, 1)
    check_outputs([out], bs)
    train_pre = DevicePreprocessor(cfg, is_train=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tin, ttg, tmeta = train_pre(stacked, generator=gen)
    require(tin["r_rot"].shape == (bs, 3, 3), "pcl rotations in train mode")
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    losses, times, _ = run_steps(
        step, state, (tin, ttg, tmeta), 1,
        dict(K1_STEP_LAUNCHES, splat_fwd=2, splat_bwd=2),
        "hands_light pcl train", gen)
    print(f"  pcl evaluation forward and train step bs{bs} on the card: loss "
          f"{losses[0]:.4f}, step {times[0]:.1f} ms (the first) {tag}")
    del model, state, step
    torch.cuda.empty_cache()


def decomposition_phase(dev, tag, iters: int = DECOMPOSE_ITERS) -> None:
    """``cli.train_decompose`` at HaMeR ViT-H bs32 and WildHands bs64: every
    row positive, the derived rows printed (a gap that does not close is
    printed as one)."""
    from hands_tpu_torch.cli import train_decompose as td

    print(f"phase 12: cli.train_decompose, {iters} timed calls a row {tag}")
    for method, batch in (("hamer_light", TRAIN_VIT_BATCH),
                          ("hands_light", TRAIN_WH_BATCH)):
        out = td.run(method, batch, iters, dev, seed=SEED, vit=VIT,
                     backbone=WH_BACKBONE)
        for name, row in out["rows"].items():
            require(all(math.isfinite(v) and v > 0 for v in row["ms"]),
                    f"train_decompose {method} {name}: a time not positive")
            require(row["device_ms"] is not None and row["device_ms"] > 0,
                    f"train_decompose {method} {name}: no device time")
        torch.cuda.empty_cache()


TREES = "tests/test_torch_datasets.py"  # the miniature dataset trees
REAL_BATCH = 8  # images a step of the real-layout cli.train run
# steps of the learning check in the whole script: the CLI's 300 before
# (the loss fell 68.3x there on an H100 against the check's 10x); cut for
# the script's time (`python -m hands_tpu_torch.cli.numerics_check` runs 300)
LEARN_STEPS = 150


def load_trees():
    """The tree builders and expectations of the port's CPU dataset test,
    loaded by path (they import neither JAX nor the JAX package)."""
    import importlib.util

    import os

    spec = importlib.util.spec_from_file_location(
        "torch_dataset_trees", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), TREES))
    trees = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trees)
    return trees


def decoder_probe() -> str:
    """Which image decoder this machine has: prints whether ``import cv2``
    works and whether the port's native wrapper (``native/hands_host.cpp``,
    libjpeg/libpng) builds, and returns the route ``_read_image`` takes."""
    from hands_tpu_torch.data.datasets import image_decoder
    from hands_tpu_torch.utils import native

    try:
        import cv2
        cv2_line = f"works (cv2 {cv2.__version__})"
    except ImportError as err:
        cv2_line = f"fails ({err})"
    try:
        native_line = f"builds ({native.build().name})"
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        first = [ln for ln in str(err).splitlines()[1:] if "error" in ln]
        native_line = f"does not build ({(first or [str(err)])[0].strip()})"
    decoder = image_decoder()
    print(f"image decoders: import cv2 {cv2_line}; the port's native "
          f"wrapper {native_line}; _read_image decodes with: {decoder}")
    return decoder


def real_layout_phase(dev, tag, decoder: str) -> None:
    """Phase 13: the real-layout path at full width. The miniature trees of
    every family (the builders of the CPU test) under a temporary
    ``$DATA_DIR``; all twelve names resolved and held to the CPU test's
    record counts, flags and decoded images; ``cli.train`` of WildHands (two
    ResNet-50s, 224^2, bf16, mask and grasp losses on) on the config's
    default mix for one epoch of ``REAL_BATCH`` images a step, validated on
    ``epic``; ``cli.evaluate --infer_ckpt`` on its ``last``; ``cli.demo
    --ckpt`` on the tree's images, bit-equal to ``restore_params`` +
    ``serve`` and unlike random weights."""
    import glob
    import os
    import tempfile

    from hands_tpu_torch.cli import demo as cli_demo
    from hands_tpu_torch.cli import evaluate as cli_evaluate
    from hands_tpu_torch.cli import train as cli_train
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data import datasets as TD
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.checkpoint import CheckpointManager

    trees = load_trees()
    print(f"phase 13: the real datasets' layouts, WildHands {WH_BACKBONE} x "
          f"2, {REAL_BATCH} images a step {tag}")
    require(decoder != "none", "no image decoder (neither cv2 nor the native "
            "wrapper): the trees' images cannot be read")
    bs = REAL_BATCH
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(
            os.environ, {"DATA_DIR": os.path.join(tmp, "data")}):
        data = os.environ["DATA_DIR"]
        t0 = time.time()
        trees.build_tree(data)
        over = {"backbone": WH_BACKBONE}  # the config's own on the card
        cfg = default_config("hands_light", **over)
        counts = {}
        for name in sorted(trees.EXPECTED):
            split = trees.EXPECTED[name][0]
            trees.check_records(TD.fetch_dataset(cfg, name, split), name)
            counts[name] = trees.EXPECTED[name][1]
        mix = TD.fetch_dataset(cfg, trees.TRAIN_MIX, "train")
        require(cfg.dataset == trees.TRAIN_MIX and isinstance(
            mix, TD.ConcatDataset) and len(mix) == trees.TRAIN_MIX_LEN,
            "the config's default mix on the tree")
        print(f"  built the trees and resolved all {len(counts)} names in "
              f"{time.time() - t0:.1f} s, images decoded with {decoder}: "
              f"{counts}; the mix {trees.TRAIN_MIX}: {len(mix)} records")

        steps = len(mix) // bs
        common = ["--eval_on", "epic", "--test_batch_size", str(bs),
                  "--num_workers", "4", "--mute", "--no_vis", "--device",
                  str(dev)]
        root = os.path.join(tmp, "logs")
        reset_launch_counts()
        state = cli_train.main(
            common + ["--dataset", trees.TRAIN_MIX, "--batch_size", str(bs),
                      "--num_epoch", "1", "--eval_every_epoch", "1",
                      "--log_every", "1", "--exp_key", "real"],
            log_root=root, overrides=over)
        torch.cuda.synchronize()
        require(state.step == steps, f"cli.train took {state.step} steps, "
                f"want {steps}")
        # sanity validation, the steps, one validation batch (3 EPIC records)
        check_launches(f"cli.train on {trees.TRAIN_MIX}", launch_counts(), {
            "lbs_apply": 4 * (steps + 2), "lbs_apply_bwd": 2 * steps,
            "splat_fwd": 2 * (steps + 2), "splat_bwd": 2 * steps}, 1)
        print(f"  = per step lbs_apply 4, lbs_apply_bwd 2, splat_fwd 2, "
              f"splat_bwd 2 over {steps} steps (+ 4 and 2 a validation)")
        exp_dir = os.path.join(root, "real")
        logged = [json.loads(ln) for ln in
                  open(os.path.join(exp_dir, "metrics.jsonl"))]
        train_rows = [r for r in logged if "loss__train" in r]
        val_rows = [r for r in logged if "loss__val" in r]
        require(len(train_rows) == steps and len(val_rows) == 1
                and all(np.isfinite(v) for r in logged for v in r.values()),
                "metrics.jsonl: a window a step, one validation, finite")
        require("loss/mask/r__train" in train_rows[0]
                and "metric.pix_err/h__val" in val_rows[0],
                "the mask loss and the EPIC metrics are logged")
        print("  loss__train " + ", ".join(
            f"{r['loss__train']:.3f}" for r in train_rows)
            + f"; loss__val (epic) {val_rows[0]['loss__val']:.4f}, pix_err "
            f"{val_rows[0]['metric.pix_err/h__val']:.2f} px")

        last = os.path.join(exp_dir, "checkpoints", "last")
        reset_launch_counts()
        metrics = cli_evaluate.main(
            common + ["--infer_ckpt", last, "--exp_key", "evaluate"],
            log_root=root, overrides=over)
        torch.cuda.synchronize()
        check_launches("cli.evaluate --infer_ckpt on epic", launch_counts(),
                       {"lbs_apply": 4, "splat_fwd": 2}, 1)
        want = val_rows[0]["loss__val"]
        err = abs(metrics["loss"] - want) / abs(want)
        print(f"  cli.evaluate --infer_ckpt last: loss {metrics['loss']:.6f} "
              f"against loss__val {want:.6f}, relative {err:.2e} (<= 1e-05)")
        require(err <= 1e-5, "cli.evaluate does not reproduce loss__val")

        # serve the checkpoint: cli.demo against restore_params + serve
        images = os.path.join(data, "epic_frames")
        paths = sorted(glob.glob(os.path.join(images, "*.jpg")))
        argv = ["--dir", images, "--dtype", "bfloat16", "--batch_size",
                str(len(paths)), "--device", str(dev)]
        reset_launch_counts()
        require(cli_demo.main(argv + ["--ckpt", last, "--no_vis", "--out",
                                      os.path.join(tmp, "demo")], over) == 0,
                "cli.demo --ckpt")
        torch.cuda.synchronize()
        check_launches("cli.demo --ckpt", launch_counts(), {"lbs_apply": 2},
                       1)
        scfg = cli_demo.serving_config("hands_light", "bfloat16").replace(
            **over)
        model = fetch_model(scfg, device=dev, seed=SEED)
        recs = [cli_demo.make_record(p, TD._read_image(p)[0]) for p in paths]
        rnd = cli_demo.serve(recs, scfg, model, dev).to_np()
        left = CheckpointManager(os.path.dirname(last)).restore_params(
            model, "last")
        require(left == [], f"restore_params left {left[:4]} at init")
        out = cli_demo.serve(recs, scfg, model, dev).to_np()
        n_equal = n_keys = 0
        for i, p in enumerate(paths):
            stem = os.path.splitext(os.path.basename(p))[0]
            got = np.load(os.path.join(tmp, "demo", f"{stem}_pred.npz"))
            for k in got.files:
                n_keys += 1
                n_equal += int(np.array_equal(got[k], out[k][i]))
            require(not np.array_equal(got["pred.mano.pose.r"],
                                       rnd["pred.mano.pose.r"][i]),
                    f"{stem}: the checkpoint serves random-init predictions")
        print(f"  cli.demo --ckpt last on {len(paths)} images: {n_equal} of "
              f"{n_keys} prediction arrays bit-equal to restore_params + "
              f"serve on the card; every image unlike random weights")
        require(n_equal == n_keys, "cli.demo --ckpt differs from "
                "restore_params + serve")
        del state, model
        torch.cuda.empty_cache()


def learning_phase(dev, tag, steps: int = LEARN_STEPS) -> dict:
    """Phase 14: ``cli.numerics_check``, the learning check: WildHands
    (ResNet-18, bf16, lr 3e-4) overfits one synthetic batch of 16; the loss
    must fall more than 10x in ``steps`` steps with a finite pix_err."""
    from hands_tpu_torch.cli import numerics_check

    print(f"phase 14: cli.numerics_check, {steps} steps bs"
          f"{numerics_check.BATCH} {tag}")
    reset_launch_counts()
    try:
        out = numerics_check.learning_check(steps, dev)
    except AssertionError as err:
        require(False, f"the learning check did not drop the loss 10x: {err}")
    torch.cuda.synchronize()
    n = out["train_steps"]
    # a train step: GT processing and the forward skin twice each; the eval
    # step's forward and GT processing; no mask loss, so no splat
    check_launches("cli.numerics_check", launch_counts(),
                   {"lbs_apply": 4 * n + 4, "lbs_apply_bwd": 2 * n}, 1)
    require(math.isfinite(out["loss1"]) and math.isfinite(out["pix_err"])
            and out["loss1"] < out["loss0"] / 10, "learning check numbers")
    busy = out["busy_share"]
    print(f"  learning check: loss0 {out['loss0']:.4f} -> loss1 "
          f"{out['loss1']:.4f} ({out['loss0'] / out['loss1']:.1f}x) in "
          f"{steps} steps, {out['ms_per_step']:.2f} ms a step, pix_err "
          f"{out['pix_err']:.2f} px, device busy "
          + ("not measured" if busy is None else f"{100 * busy:.1f}%")
          + f" {tag}")
    return out


def int8_drift_phase(dev, tag) -> None:
    """Phase 15: ``cli.int8_accuracy``, full-depth ViT-H HaMeR on one batch
    of 32 synthetic records, bf16 (K3) against int8 (K5), without and with
    the tanh GELU: the drift lines, finite, and each path's launches."""
    from hands_tpu_torch.cli import int8_accuracy

    print(f"phase 15: cli.int8_accuracy, ViT-{VIT} HaMeR, 32 images {tag}")
    for fast in (False, True):
        reset_launch_counts()
        rows_d = int8_accuracy.drift(fast_gelu=fast, batch=32, device=dev,
                                     vit=VIT)
        torch.cuda.synchronize()
        depth = 32 if VIT == "h" else 2
        check_launches(f"int8_accuracy{' --fast_gelu' if fast else ''}",
                       launch_counts(), {
                           "vit_layernorm": 2 * depth, "vit_gemm": 4 * depth,
                           "vit_attention": depth, "ln_quant_dynamic":
                           2 * depth, "quant_rows": 2 * depth,
                           "gemm_i8_dynamic": 4 * depth,
                           "qkv_attention_dynamic": depth, "lbs_apply": 4}, 1)
        require(all(math.isfinite(r["max"]) for r in rows_d.values())
                and "mano.vertices.r" in rows_d, "int8 drift rows")
        v = rows_d["mano.vertices.r"]
        print(f"  int8{' + fast_gelu' if fast else ''} against bf16, "
              f"vertices.r: max {v['max']:.3e} mean {v['mean']:.3e} m "
              f"(random weights) {tag}")
        torch.cuda.empty_cache()


def run_steps(step, state, batch, n, per_step, path, gen=None):
    """``n`` train steps on one batch, each with the launch counts set to 0
    before it and checked after it. Returns (losses, ms of each step, the
    summed counts)."""
    losses, times, total = [], [], {}
    for i in range(n):
        reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches(f"{path} step {i + 1}", counts, per_step, 1)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        require(all(bool(torch.isfinite(v)) for v in logs.values()),
                f"{path}: non-finite loss term in step {i + 1}")
        losses.append(float(logs["loss"]))
        times.append(start.elapsed_time(end))
    return losses, times, total


def steps_ms(step, state, batch, n=2, gen=None):
    """(best ms per step, peak GB a step adds) over ``n`` steps."""
    best, peak = float("inf"), 0.0
    for _ in range(n):
        ms, gb = peak_ms(lambda: step(state, batch, gen), iters=1, warmup=0)
        best, peak = min(best, ms), max(peak, gb)
    return best, peak


def tiny_train_check(method, cfg_kw, model_kw, dev, rel, steps=2) -> None:
    """The train step at a small size on the card (kernels) against the CPU
    (twins): the same weights and batch, the dropout rate set to 0 (a mask
    cannot be shared between the two devices' generators)."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    cfg = default_config(method, lr=1e-6, **TINY_TRAIN, **cfg_kw)
    cpu = fetch_model(cfg, "cpu", seed=SEED, **model_kw)
    for mod in cpu.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
    gpu = copy.deepcopy(cpu).to(dev)
    logs = {}
    for name, model, where in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        batch = make_batch(cfg, 2, seed=SEED, device=where)
        state = create_train_state(cfg, model)
        step = make_train_step(model, cfg)
        gen = torch.Generator(device=where).manual_seed(SEED)
        for _ in range(steps):
            state, out = step(state, batch, gen)
        logs[name] = {k: float(v) for k, v in out.items()}
    for k in ("loss", "grad_norm"):
        a, b = logs["cpu"][k], logs["gpu"][k]
        err = abs(a - b) / max(abs(a), 1e-3)
        print(f"  tiny {method} train step {steps} GPU vs CPU {k}: {b:.6g} vs "
              f"{a:.6g}, relative {err:.3e} (<= {rel:g})")
        require(err <= rel, f"tiny {method} train step: {k} differs")


def hamer_train_phase(rows, dev, tag) -> None:
    """HaMeR ViT-H, full width and depth, bf16 with f32 masters, the fused
    block (K4), grasp loss on: optimiser steps on one synthetic batch of 32
    images (64 crops), one more with the mask loss on, and the same steps
    with the plain block under per-block checkpointing and without."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    bs = TRAIN_VIT_BATCH
    print(f"phase 7: HaMeR ViT-{VIT} train steps, {bs} images ({2 * bs} "
          f"crops) a step, bf16 compute, f32 masters, fused_block {tag}")
    # lr: from random weights the first Adam steps at 1e-4 (every weight
    # moved by lr at once) overshoot the weak-perspective scale and the 2D
    # loss explodes, in the JAX package alike; 1e-6 descends
    cfg = default_config("hamer_light", compute_dtype="bfloat16",
                         fused_block=True, use_render_seg_loss=False, lr=1e-6)
    cfg_mask = cfg.replace(use_render_seg_loss=True)
    require(cfg.use_grasp_loss, "the HaMeR train config classifies grasps")
    t0 = time.time()
    model = fetch_model(cfg_mask, device=dev, seed=SEED, vit_variant=VIT,
                        param_dtype=torch.float32)
    batch = make_batch(cfg_mask, bs, seed=SEED, device=dev)
    state = create_train_state(cfg, model)
    n_param = sum(p.numel() for p in state.params)
    torch.cuda.synchronize()
    print(f"  model ({n_param / 1e6:.1f} M parameters), optimiser state and "
          f"batch made in {time.time() - t0:.1f} s; allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    depth = len(model.net.backbone.blocks)
    # K4's forward and backward in every block; the skinning of both hands
    # for the 2D and 3D losses, twice (predicted and ground-truth hands), and
    # its gradient for the predicted ones
    per_step = {k: depth * (K4_FWD_LAUNCHES.get(k, 0) + n)
                for k, n in K4_BWD_LAUNCHES.items()}
    per_step.update(K1_STEP_LAUNCHES)

    model.cfg = cfg
    step = make_train_step(model, cfg)
    losses, times, total = run_steps(step, state, batch, TRAIN_STEPS, per_step,
                                     "hamer_light train")
    print(f"  losses of {TRAIN_STEPS} steps on one batch at lr {cfg.lr:g}: "
          + ", ".join(f"{v:.4f}" for v in losses)
          + "; ms: " + ", ".join(f"{t:.1f}" for t in times))
    require(losses[-1] < losses[0], "the loss did not fall on a repeated batch")
    require(state.step == TRAIN_STEPS and state.tx.count == TRAIN_STEPS,
            "step counters")
    # K4's line: K3's kernels, forward and recompute; each backward kernel
    # its own (layernorm_bwd with its column-sum launches beside)
    rows["vit_block_fused_trainable"]["launches"] = sum(
        total[k] for k in ("vit_layernorm", "vit_gemm", "vit_attention"))
    for k in BWD_KERNELS:
        rows[k]["launches"] = total[k]
    rows["layernorm_bwd"]["sum_launches"] = total["layernorm_bwd_sums"]

    # one more step with the mask loss on: K2 forward and backward twice
    model.cfg = cfg_mask
    step_mask = make_train_step(model, cfg_mask)
    losses_m, _, _ = run_steps(
        step_mask, state, batch, 1,
        dict(per_step, splat_fwd=2, splat_bwd=2), "hamer_light train + mask")
    print(f"  with the mask loss on: loss {losses_m[0]:.4f}")
    model.cfg = cfg

    # ms and memory: K4, then the plain block with and without checkpoints
    results = {}
    results["K4 (fused_block)"] = steps_ms(step, state, batch)
    blocks = model.net.backbone.blocks
    for name, ckpt in (("plain block + checkpoint", True),
                       ("plain block", False)):
        for blk in blocks:
            blk.fused = blk.fused_train = False
        model.net.backbone.use_checkpoint = ckpt
        reset_launch_counts()
        results[name] = steps_ms(step, state, batch)
        check_launches(f"hamer_light train, {name}", launch_counts(),
                       K1_STEP_LAUNCHES, 2)
    for blk in blocks:
        blk.fused = blk.fused_train = True
    model.net.backbone.use_checkpoint = False
    again = steps_ms(step, state, batch)
    results["K4 (fused_block)"] = (min(again[0], results["K4 (fused_block)"][0]),
                                   results["K4 (fused_block)"][1])
    for name, (ms, gb) in results.items():
        print(f"  hamer_light train step bs{bs}, {name}: {ms:.1f} ms "
              f"({2 * bs / ms * 1e3:.1f} crops/s), peak +{gb:.2f} GB over "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held {tag}")
    del model, state, step, step_mask, batch
    torch.cuda.empty_cache()
    tiny_train_check("hamer_light",
                     dict(compute_dtype="bfloat16", fused_block=True),
                     dict(vit_variant="tiny", param_dtype=torch.float32), dev,
                     rel=SERVE_REL)


def wildhands_train_phase(rows, dev, tag) -> None:
    """WildHands, two ResNet-50s, the default config (bf16, grasp and mask
    loss on): optimiser steps on one synthetic batch of 64 images in train
    mode (batch statistics, dropout), then one eval step with its metrics."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.ops.procrustes import similarity_align
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_eval_step, make_train_step

    bs = TRAIN_WH_BATCH
    print(f"phase 8: WildHands train steps, {WH_BACKBONE} x 2, {bs} images "
          f"({2 * bs} crops) a step, default config {tag}")
    cfg = default_config("hands_light", backbone=WH_BACKBONE)
    require(cfg.use_render_seg_loss and cfg.use_grasp_loss
            and cfg.compute_dtype == "bfloat16", "the default train config")
    cfg_nomask = cfg.replace(use_render_seg_loss=False)
    model = fetch_model(cfg, device=dev, seed=SEED)
    batch = make_batch(cfg, bs, seed=SEED, device=dev)
    state = create_train_state(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_train_step(model, cfg)
    bn = model.net.hand_backbone.bn_stem
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    per_step = dict(K1_STEP_LAUNCHES, splat_fwd=2, splat_bwd=2)
    losses, times, total = run_steps(step, state, batch, TRAIN_STEPS, per_step,
                                     "hands_light train", gen)
    print(f"  losses of {TRAIN_STEPS} steps on one batch at lr {cfg.lr:g}: "
          + ", ".join(f"{v:.4f}" for v in losses)
          + "; ms: " + ", ".join(f"{t:.1f}" for t in times))
    for k in per_step:
        rows[k]["launches"] = total[k]
    moved = float((bn.running_mean - mean0).abs().max())
    require(moved > 0 and not torch.equal(bn.running_var, var0)
            and bool(torch.isfinite(bn.running_var).all()),
            "BatchNorm's running statistics did not move")
    print(f"  the stem's running mean moved by up to {moved:.3e}; training "
          f"mode {model.training}")

    step_nomask = make_train_step(model, cfg_nomask)

    def nomask():
        model.cfg = cfg_nomask
        out = steps_ms(step_nomask, state, batch, gen=gen)
        model.cfg = cfg
        return out

    # kernels, no mask, twins, no mask, kernels: the better of each pair
    k_ms, k_gb = steps_ms(step, state, batch, gen=gen)
    n_ms, n_gb = nomask()
    with geometry_twins():
        t_ms, t_gb = steps_ms(step, state, batch, gen=gen)
    n_ms = min(n_ms, nomask()[0])
    k_ms2, _ = steps_ms(step, state, batch, gen=gen)
    held = torch.cuda.memory_allocated() / 1e9
    print(f"  hands_light train step bs{bs}: kernels {min(k_ms, k_ms2):.1f} ms "
          f"({bs / min(k_ms, k_ms2) * 1e3:.1f} images/s), peak +{k_gb:.2f} GB; "
          f"K1 and K2 as twins {t_ms:.1f} ms, peak +{t_gb:.2f} GB; without "
          f"the mask loss {n_ms:.1f} ms, peak +{n_gb:.2f} GB; over {held:.2f} "
          f"GB held {tag}")
    busy_line(f"hands_light train step bs{bs}",
              lambda: step(state, batch, gen), min(k_ms, k_ms2), tag)

    # ---- one eval step: forward, losses, denormalised 2D, metrics
    eval_step = make_eval_step(model, cfg)
    eval_step(state, batch)  # warm-up (cuSOLVER's handle)
    reset_launch_counts()
    metrics, logs = eval_step(state, batch)
    torch.cuda.synchronize()
    check_launches("hands_light eval step", launch_counts(),
                   {"lbs_apply": 4, "splat_fwd": 2}, 1)
    require(not model.training, "the eval step left the model in train mode")
    for key in ("mrrpe/r/l", "mpjpe/ra/h", "mpjpe/pa/ra/h", "pix_err/h"):
        v = metrics[key]
        require(v.shape[0] == bs and bool(torch.isfinite(v).all()),
                f"metric {key}: every hand of the batch is valid")
    require(bool(torch.isfinite(logs["loss"])), "eval loss")
    e_ms = min(cuda_ms(lambda: eval_step(state, batch), iters=3)
               for _ in range(2))
    busy_line(f"hands_light eval step bs{bs}",
              lambda: eval_step(state, batch), e_ms, tag)
    pts = torch.randn((2 * bs, 21, 3), generator=gen, device=dev) * 0.05
    tgt = torch.randn((2 * bs, 21, 3), generator=gen, device=dev) * 0.05
    svd_ms = min(cuda_ms(lambda: similarity_align(pts, tgt), iters=5)
                 for _ in range(2))
    cpu_pts, cpu_tgt = pts.cpu(), tgt.cpu()
    t = time.perf_counter()
    ref = similarity_align(cpu_pts, cpu_tgt)
    cpu_ms = (time.perf_counter() - t) * 1e3
    compare_abs("similarity_align on the card vs the CPU",
                similarity_align(pts, tgt).cpu(), ref, 1e-5)
    print(f"  eval step bs{bs}: {e_ms:.2f} ms; mpjpe/ra/h "
          f"{float(metrics['mpjpe/ra/h'].mean()):.1f} mm, mpjpe/pa/ra/h "
          f"{float(metrics['mpjpe/pa/ra/h'].mean()):.1f} mm (random "
          f"weights); Procrustes of {2 * bs} hands (one batched 3x3 SVD) "
          f"{svd_ms:.3f} ms of it, {cpu_ms:.3f} ms on the host's CPU {tag}")
    del model, state, step, batch
    torch.cuda.empty_cache()
    tiny_train_check("hands_light",
                     dict(backbone="resnet18", compute_dtype="float32"), {},
                     dev, rel=1e-3, steps=1)


# ---- phase 16: the other model families and the ViT remainder
FAM_SERVE = ((8, 2), (32, 2))  # (images a request, requests)
FAM_TRAIN_BATCH = 32  # images a train step: 64 crops
B16_HEADS, B16_TOK, B16_C, B16_HIDDEN = 12, 196, 768, 3072  # 224^2 ViT-B/16
B16_TRAIN_BATCH = 16  # images of the ViT-B/16 WildHands step: 32 crops
K3_NAMES = ("vit_layernorm", "vit_gemm", "vit_attention")
FAMILY_ROWS = K3_NAMES + ("lbs_apply", "lbs_apply_bwd", "splat_fwd",
                          "splat_bwd", "attention_bwd", "layernorm_bwd",
                          "gelu_bwd")


def note_launches(rows, path, counts) -> None:
    """Add a path's launch counts to the kernels' lines (``launches_on``)."""
    for k, n in counts.items():
        if n and k in rows:
            rows[k].setdefault("launches_on", {})[path] = n


def block_twins():
    """Every bf16 block kernel of a model swapped for its plain twin."""
    from hands_tpu_torch.models.backbones import vit as vit_mod
    from hands_tpu_torch.ops import vit_block as vb

    return mock.patch.object(
        vit_mod, "vit_block_fused_trainable",
        lambda x, params, num_heads, fast_gelu=False: vb.vit_block_plain(
            x.to(torch.bfloat16), vb._cast_params(params), num_heads,
            fast_gelu))


def spread(a, b) -> str:
    return f"{a:.2f} / {b:.2f} (spread {abs(a - b) / min(a, b):.1%})"


def serve_readings(what, batches, cfg, model, dev, tag) -> None:
    """Serving rate twice (host clock around a synchronise) and one
    request's device time."""
    from hands_tpu_torch.cli.demo import serve

    (r1, m1), (r2, m2) = (serve_rate(batches, cfg, model, dev)
                          for _ in range(2))
    busy, _ = device_busy_ms(lambda: serve(batches[0], cfg, model, dev))
    dev_ms = "not measured" if busy is None else f"{busy:.2f} ms"
    print(f"  {what}: {spread(r1, r2)} crops/s, {min(m1, m2):.2f} ms a "
          f"request, device busy {dev_ms} a request {tag}")


def step_readings(what, step, state, batch, gen, images, tag) -> None:
    """A train step's ms twice (CUDA events), its peak above what is held,
    and its device time with the idle share."""
    (t1, g1), (t2, g2) = (steps_ms(step, state, batch, gen=gen)
                          for _ in range(2))
    held = torch.cuda.memory_allocated() / 1e9
    print(f"  {what} train step bs{images}: {spread(t1, t2)} ms "
          f"({images / min(t1, t2) * 1e3:.1f} images/s), peak +"
          f"{max(g1, g2):.2f} GB over {held:.2f} GB held {tag}")
    busy_line(f"{what} train step bs{images}",
              lambda: step(state, batch, gen), min(t1, t2), tag)


# HandOccNet's gradient at two crops on the card against the exact one on
# the card's own branches (utils/exact.py): every leaf within
# max(GRAD_FLOOR, GRAD_CPU_RATIO x the CPU's distance on its own branches)
# in f32; the median and 95th percentile over the leaves within
# GRAD_CPU_RATIO_BF16 x the CPU's in bf16
GRAD_FLOOR, GRAD_CPU_RATIO, GRAD_CPU_RATIO_BF16 = 1e-4, 8.0, 2.0


def tiny_grad_check(method, cfg_kw, dev, rel, free=None):
    """The loss and the gradient at a small size on the card against the
    CPU, with BatchNorm on its running statistics: with the batch's,
    HandOccNet's loss is ill-conditioned at two images (its hourglass
    normalises 1 x 1 maps over four crops, and a 1e-6 relative change of
    the input moves the loss by 2e-2).

    Each device's loss is held to the exact loss (f64, ``utils/exact.py``)
    at ``rel``. The gradient jumps where a leaky ReLU's input or a max
    pool's window is within rounding of its kink: at these sizes the card
    and the CPU take another side than the f64 run at dozens of entries,
    which moves most leaves by ~1e-2 on either device. So each device's
    gradient is held to the exact gradient on the branches that device
    took (``record_branches``). In f32 every leaf must lie within
    max(GRAD_FLOOR, GRAD_CPU_RATIO x the CPU's distance on that leaf): the
    card sums in other orders than the CPU, which weighs most on the
    worst-conditioned leaves, the FIT gate's (a sigmoid of sums of 1024
    products). Leaves whose exact gradient is zero by a shift invariance
    (under 1e-6 of the largest entry) are left out. In bf16 the median and
    95th percentile over the leaves must lie within GRAD_CPU_RATIO_BF16 x
    the CPU's.

    ``free`` is what an earlier call returned: its f64 run (on the f64
    run's own branches) is reused where the weights and the batch are the
    same, as they are for two compute dtypes. Returns it."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.core.precision import f32_exact
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.step import forward_and_loss
    from hands_tpu_torch.utils.exact import exact_grads, record_branches

    cfg = default_config(method, **TINY_TRAIN, **cfg_kw)
    cpu = fetch_model(cfg, "cpu", seed=SEED)
    names = [n for n, _ in cpu.named_parameters()]
    batch = make_batch(cfg, 2, seed=SEED, device="cpu")
    inputs = [t for t in cpu.state_dict().values()] + [
        v for d in batch for v in d.values()]
    if free is None or len(free[0]) != len(inputs) or not all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(free[0], inputs)):
        free = (inputs, exact_grads(cpu, cfg, batch))
    exact_loss, _, free_grads = free[1]
    top = max(float(t.abs().max()) for t in free_grads if t is not None)
    def distances(grads, ref):
        return np.array([
            float((g.double().cpu() - t).abs().max() / t.abs().max())
            if g is not None and t is not None
            and float(t.abs().max()) > 1e-6 * top else np.nan
            for g, t in zip(grads, ref)])

    def summary(d):
        return "{:.2e} / {:.2e} / {:.2e}".format(
            *np.nanpercentile(d, [50, 95]), np.nanmax(d))

    losses, dist, taken, free_lines = {}, {}, {}, []
    for name, where in (("cpu", "cpu"), ("gpu", dev)):
        model = copy.deepcopy(cpu).to(where)
        b = tuple({k: v.to(where) for k, v in d.items()} for d in batch)
        with f32_exact(), record_branches() as sides:
            total, _, _, _ = forward_and_loss(model, cfg, b)
            grads = torch.autograd.grad(total, list(model.parameters()),
                                        allow_unused=True)
        losses[name] = float(total.detach())
        taken[name] = sides
        _, _, exact = exact_grads(cpu, cfg, batch, sides)
        dist[name] = distances(grads, exact)
        free_lines.append(
            f"{name.upper()} {summary(distances(grads, free_grads))}")
    flips = sum(int((a != b).sum()) for a, b in zip(taken["gpu"],
                                                    taken["cpu"]))
    err = {k: abs(v - exact_loss) / abs(exact_loss) for k, v in losses.items()}
    g, c = dist["gpu"], dist["cpu"]
    pct = {k: np.nanpercentile(v, [50, 95]) for k, v in dist.items()}
    print(f"  tiny {method} {cfg.compute_dtype} (running statistics) loss: "
          f"GPU {losses['gpu']:.6g}, CPU {losses['cpu']:.6g}, exact "
          f"{exact_loss:.6g}, relative to it {err['gpu']:.3e} and "
          f"{err['cpu']:.3e} (<= {rel:g}); gradient against the exact one on "
          f"each device's branches (max|d| / max|exact| a leaf), median / "
          f"95th percentile / max: GPU {summary(g)}, CPU {summary(c)}; on "
          f"the f64 run's branches: {', '.join(free_lines)}; "
          f"{len(taken['gpu'])} kinks, {flips} entries on another side on "
          f"the card than on the CPU")
    require(max(err.values()) <= rel,
            f"tiny {method}: the loss is off the exact one")
    if cfg.compute_dtype == "float32":
        bound = np.maximum(GRAD_FLOOR, GRAD_CPU_RATIO * np.nan_to_num(c))
        over = [(names[i], g[i], c[i]) for i in np.flatnonzero(g > bound)]
        worst = int(np.nanargmax(g / bound))
        print(f"    every leaf <= max({GRAD_FLOOR:g}, {GRAD_CPU_RATIO:g} x "
              f"the CPU's): the closest {names[worst]} at "
              f"{g[worst] / bound[worst]:.2f} of its bound; "
              f"{len(over)} over")
        require(not over, f"tiny {method}: leaves further from the exact "
                f"gradient on the card than allowed: {over[:5]}")
    else:
        print(f"    median and 95th percentile <= {GRAD_CPU_RATIO_BF16:g} x "
              f"the CPU's")
        require(bool((pct["gpu"] <= GRAD_CPU_RATIO_BF16 * pct["cpu"]).all()),
                f"tiny {method}: the card's gradient is further from the "
                f"exact one than the CPU's allows")
    return free


def family_phase(rows, dev, tag, method, overrides) -> None:
    """One model family at full width through its entry points: serving
    (``cli.demo.serve``) in bf16 at requests of 8 and 32 images, in f32 and
    bf16 + ``quant_int8`` at 32, K1 against its twin; the evaluation forward with the
    render and the grasp classifier on; three train steps of the method's
    default config at 32 images; the train step at a small size against the
    CPU."""
    from hands_tpu_torch.cli.demo import serve, serving_config
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model, inference_pose
    from hands_tpu_torch.ops import rasterizer
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    name = method[:-len("_light")]
    requests = {bs: make_requests(n, bs, SEED + 300 + bs)
                for bs, n in FAM_SERVE}
    for label, kw in (("f32", dict(dtype="float32")),
                      ("bf16", dict(dtype="bfloat16")),
                      ("bf16 quant_int8", dict(dtype="bfloat16",
                                               quant_int8=True))):
        cfg = serving_config(method, **kw).replace(**overrides)
        model = fetch_model(cfg, device=dev, seed=SEED)
        # every size in bf16, the serving default; the largest in the others
        for bs, n in FAM_SERVE if label == "bf16" else FAM_SERVE[-1:]:
            batches = requests[bs]
            serve(batches[0], cfg, model, dev)  # warm-up
            reset_launch_counts()
            outs = [serve(recs, cfg, model, dev) for recs in batches]
            torch.cuda.synchronize()
            counts = launch_counts()
            check_launches(f"{name} serve {label} bs{bs}", counts,
                           {"lbs_apply": 2}, n)
            note_launches(rows, f"{name} serve bs{bs}, {n} requests", counts)
            check_outputs(outs, bs)
            with geometry_twins():
                ref = serve(batches[0], cfg, model, dev)
            for side in ("r", "l"):
                key = f"pred.mano.vertices.{side}"
                compare_abs(f"{name} serve {label} bs{bs} vertices.{side}",
                            outs[0][key], ref[key], LBS_ABS)
            serve_readings(f"{name} {label} serve bs{bs} ({2 * bs} crops)",
                           batches, cfg, model, dev, tag)
        del model
        part(f"{name} serving {label}")

    # ---- the evaluation forward: the config's defaults, render and grasp
    cfg = default_config(method, **overrides)
    require(cfg.use_render_seg_loss and cfg.use_grasp_loss
            and cfg.compute_dtype == "bfloat16", f"{name}: the default config")
    model = fetch_model(cfg, device=dev, seed=SEED)
    bs = FAM_SERVE[-1][0]
    pre = DevicePreprocessor(cfg, is_train=False, device=dev)
    inputs, _, meta = pre(stack_records(requests[bs][0]))
    inference_pose(model, inputs, meta)  # warm-up
    reset_launch_counts()
    out = inference_pose(model, inputs, meta)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(f"{name} evaluation forward bs{bs}", counts,
                   {"lbs_apply": 2, "splat_fwd": 2}, 1)
    note_launches(rows, f"{name} evaluation forward", counts)
    check_outputs([out], bs)
    for key, shape in (("pred.render.r", (bs, 224, 224)),
                       ("pred.grasp.l", (bs, 9))):
        require(out[key].shape == shape
                and bool(torch.isfinite(out[key]).all()), f"{key} output")
    with mock.patch.object(rasterizer, "splat_silhouette_fused",
                           rasterizer.splat_silhouette_plain):
        ref = inference_pose(model, inputs, meta)
    for side in ("r", "l"):
        compare_abs(f"{name} evaluation render.{side} (K2 vs twin)",
                    out[f"pred.render.{side}"], ref[f"pred.render.{side}"],
                    MASK_ABS)
    f_ms = [peak_ms(lambda: inference_pose(model, inputs, meta), warmup=2)
            for _ in range(2)]
    print(f"  {name} evaluation forward bs{bs} ({2 * bs} crops, render and "
          f"grasp on): {spread(f_ms[0][0], f_ms[1][0])} ms, peak "
          f"+{max(g for _, g in f_ms):.2f} GB {tag}")
    busy_line(f"{name} evaluation forward bs{bs}",
              lambda: inference_pose(model, inputs, meta),
              min(m for m, _ in f_ms), tag)
    del model, out, ref
    part(f"{name} evaluation forward")

    # ---- train steps: K1 forward and gradient, K2 forward and gradient
    bs = FAM_TRAIN_BATCH
    model = fetch_model(cfg, device=dev, seed=SEED)
    batch = make_batch(cfg, bs, seed=SEED, device=dev)
    state = create_train_state(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_train_step(model, cfg)
    per_step = dict(K1_STEP_LAUNCHES, splat_fwd=2, splat_bwd=2)
    losses, times, total = run_steps(step, state, batch, TRAIN_STEPS,
                                     per_step, f"{name} train", gen)
    note_launches(rows, f"{name} train, {TRAIN_STEPS} steps", total)
    require(state.step == TRAIN_STEPS, f"{name}: step counter")
    print(f"  {name}: losses of {TRAIN_STEPS} steps on one batch of {bs} at "
          f"lr {cfg.lr:g}: " + ", ".join(f"{v:.4f}" for v in losses)
          + "; ms: " + ", ".join(f"{t:.1f}" for t in times))
    step_readings(name, step, state, batch, gen, bs, tag)
    del model, state, step, batch
    torch.cuda.empty_cache()


def vit_b16_phase(rows, dev, tag) -> None:
    """WildHands with ``backbone="vit_b_16"`` in bf16: K3's kernels at
    ViT-B/16's shapes (196 tokens, heads of 64, C 768, hidden 3072) against
    their twins, the whole block and K4 (forward, backward launches,
    every gradient leaf against autograd of the plain block); the model's
    serving forward (168 launches of K3's kernels: 2 backbones x 12 blocks
    x 7) against the same on the twins; one train step on the K4 route with
    its launches."""
    from hands_tpu_torch.cli.demo import serve, serving_config
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    crops = 2 * FAM_SERVE[0][0]
    print(f"phase 16c: WildHands vit_b_16, bf16; K3 and K4 at {crops} crops "
          f"of {B16_TOK} tokens, C {B16_C}, {B16_HEADS} heads {tag}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x, p, p32 = block_inputs(gen, dev, crops, B16_TOK, B16_C, B16_HIDDEN)
    k3, extra, _ = k3_cases(x, p, B16_HEADS)
    groups = [(K3, SRC_K3, k3)]
    b16 = {}
    check_groups(groups, {}, b16)
    check_extra(extra)
    compare("whole bf16 block (ViT-B/16)",
            vb.vit_block_fused(x, p, num_heads=B16_HEADS),
            vb.vit_block_plain(x, p, B16_HEADS), rel=BLOCK_REL)
    time_groups(groups, b16, tag, earlier=False)
    for k in K3_NAMES:
        rows[k]["vit_b16"] = {f: b16[k][f] for f in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}
    t = [cuda_ms(lambda: vb.vit_block_plain(x, p, B16_HEADS)),
         cuda_ms(lambda: vb.vit_block_fused(x, p, num_heads=B16_HEADS))]
    t += [cuda_ms(lambda: vb.vit_block_fused(x, p, num_heads=B16_HEADS)),
          cuda_ms(lambda: vb.vit_block_plain(x, p, B16_HEADS))]
    print(f"  whole ViT-B/16 block ({crops * B16_TOK} rows): kernels "
          f"{spread(t[1], t[2])} ms, twin {spread(t[0], t[3])} ms {tag}")

    # K4 at these shapes: forward, backward launches, every gradient leaf
    g = (torch.randn(x.shape, generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    xs, ps, lv = k4_leaves(x, p32)
    reset_launch_counts()
    out = vb.vit_block_fused_trainable(xs, ps, B16_HEADS)
    check_launches("K4 forward (ViT-B/16)", launch_counts(), K4_FWD_LAUNCHES,
                   1)
    xt, pt, lt = k4_leaves(x, p32)
    ref = vb.vit_block_plain(xt, vb._cast_params(pt), B16_HEADS)
    compare("K4 forward (ViT-B/16) vs twin", out.detach(), ref.detach(),
            rel=BLOCK_REL)
    reset_launch_counts()
    got = torch.autograd.grad(out, lv, g)
    torch.cuda.synchronize()
    check_launches("K4 backward (ViT-B/16)", launch_counts(),
                   K4_BWD_LAUNCHES, 1)
    want = torch.autograd.grad(ref, lt, g)
    for n, a, b in zip(["x"] + list(vb.PARAM_ORDER), got, want):
        compare_grad(f"K4 (ViT-B/16) gradient of {n}", a, b)
    del out, ref, got, want

    # the model: serving against the twins, then one train step
    cfg = serving_config("hands_light", "bfloat16").replace(
        backbone="vit_b_16")
    model = fetch_model(cfg, device=dev, seed=SEED)
    depth = sum(len(getattr(model.net, s).vit.blocks)
                for s in ("hand_backbone", "glb_backbone"))
    per_forward = {k: depth * n for k, n in K4_FWD_LAUNCHES.items()}
    require(sum(per_forward.values()) == 168, "168 K3 launches a forward")
    per_forward["lbs_apply"] = 2
    for bs, n in FAM_SERVE:
        batches = make_requests(n, bs, SEED + 400 + bs)
        serve(batches[0], cfg, model, dev)  # warm-up
        reset_launch_counts()
        outs = [serve(recs, cfg, model, dev) for recs in batches]
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches(f"vit_b_16 serve bf16 bs{bs}", counts, per_forward, n)
        note_launches(rows, f"vit_b_16 serve bs{bs}, {n} requests", counts)
        check_outputs(outs, bs)
        with block_twins(), geometry_twins():
            ref = serve(batches[0], cfg, model, dev)
        for side in ("r", "l"):
            key = f"pred.mano.vertices.{side}"
            compare(f"vit_b_16 serve bs{bs} vertices.{side} vs twins",
                    outs[0][key], ref[key], rel=SERVE_REL, mean=SERVE_REL)
        serve_readings(f"vit_b_16 bf16 serve bs{bs} ({2 * bs} crops)",
                       batches, cfg, model, dev, tag)
    del model

    tcfg = default_config("hands_light", backbone="vit_b_16")
    require(tcfg.compute_dtype == "bfloat16" and tcfg.use_render_seg_loss,
            "the default train config")
    model = fetch_model(tcfg, device=dev, seed=SEED)
    bs = B16_TRAIN_BATCH
    batch = make_batch(tcfg, bs, seed=SEED, device=dev)
    state = create_train_state(tcfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = make_train_step(model, tcfg)
    per_step = {k: depth * (K4_FWD_LAUNCHES.get(k, 0) + n)
                for k, n in K4_BWD_LAUNCHES.items()}
    per_step.update(K1_STEP_LAUNCHES, splat_fwd=2, splat_bwd=2)
    losses, _, total = run_steps(step, state, batch, 1, per_step,
                                 "vit_b_16 train", gen)
    note_launches(rows, "vit_b_16 train, 1 step", total)
    print(f"  vit_b_16 train step on the K4 route: loss {losses[0]:.4f}, "
          f"launches {dict((k, v) for k, v in total.items() if v)}")
    step_readings("vit_b_16", step, state, batch, gen, bs, tag)
    del model, state, step, batch
    torch.cuda.empty_cache()


def dense_latent_phase(rows, dev, tag) -> None:
    """HaMeR ViT-H with ``pos_enc="dense_latent"``: one request of 8 images
    on the kernels (224 launches of K3's, 2 of K1) against the same request
    on the twins."""
    from hands_tpu_torch.cli.demo import serve, serving_config
    from hands_tpu_torch.models.registry import fetch_model

    cfg = serving_config("hamer_light", "bfloat16", fused_block=True).replace(
        pos_enc="dense_latent")
    model = fetch_model(cfg, device=dev, seed=SEED, vit_variant=VIT)
    depth = len(model.net.backbone.blocks)
    print(f"phase 16d: HaMeR ViT-{VIT} (depth {depth}) with "
          f"pos_enc=dense_latent {tag}")
    req = make_requests(1, 8, SEED + 500)[0]
    serve(req, cfg, model, dev)  # warm-up
    reset_launch_counts()
    out = serve(req, cfg, model, dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    per_forward = {k: depth * n for k, n in K4_FWD_LAUNCHES.items()}
    per_forward["lbs_apply"] = 2
    check_launches("hamer_light dense_latent serve bs8", counts, per_forward,
                   1)
    note_launches(rows, "hamer_light dense_latent serve bs8", counts)
    check_outputs([out], 8)
    require("inputs.r_dense_angle" in out, "the dense angle map is an input")
    with block_twins(), geometry_twins():
        ref = serve(req, cfg, model, dev)
    for side in ("r", "l"):
        key = f"pred.mano.vertices.{side}"
        compare(f"dense_latent vertices.{side} vs twins", out[key], ref[key],
                rel=SERVE_REL, mean=SERVE_REL)
    del model


def resnet_reference_sd(gen, stages=(3, 4, 6, 3)) -> dict:
    """Random weights in torchvision's ResNet-50 state-dict layout."""
    sd = {}

    def draw(name, *shape):
        t = torch.randn(shape, generator=gen) * 0.05
        return t.abs() + 0.5 if name.endswith("running_var") else t

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = draw(name, o, i, k, k)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{leaf}"] = draw(f"{name}.{leaf}", c)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, n in enumerate(stages):
        width = 64 * 2**i
        for b in range(n):
            pre, ci = f"layer{i + 1}.{b}", cin if b == 0 else 4 * width
            for k, (o, c_in, ks) in enumerate(((width, ci, 1),
                                               (width, width, 3),
                                               (4 * width, width, 1))):
                conv(f"{pre}.conv{k + 1}", o, c_in, ks)
                bn(f"{pre}.bn{k + 1}", o)
            if b == 0:
                conv(f"{pre}.downsample.0", 4 * width, ci, 1)
                bn(f"{pre}.downsample.1", 4 * width)
        cin = 4 * width
    return sd


def checkpoint_phase(dev, tag) -> None:
    """A reference-layout ResNet-50 file through ``cli.convert_ckpt``, then
    one ``cli.train`` step of full-width WildHands with ``--load_backbone``
    on it: both backbones hold the file's tensors before the step."""
    import os
    import tempfile

    from hands_tpu_torch.cli import convert_ckpt
    from hands_tpu_torch.cli import train as cli_train
    from hands_tpu_torch.data.datasets import SyntheticRecordDataset
    from hands_tpu_torch.train import trainer as trainer_mod

    bs = FAM_SERVE[0][0]
    print(f"phase 16e: cli.convert_ckpt --arch resnet50, then cli.train "
          f"--load_backbone, WildHands {WH_BACKBONE} x 2, {bs} images {tag}")
    sd = resnet_reference_sd(torch.Generator().manual_seed(SEED + 17))
    graft = trainer_mod.graft_backbone_variables
    seen = {}

    def recording_graft(model, converted):
        scopes = graft(model, converted)
        seen["scopes"] = scopes
        seen["state"] = {k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
        return scopes

    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(
            SyntheticRecordDataset._SPLIT_LEN, {"train": bs}), \
            mock.patch.object(trainer_mod, "graft_backbone_variables",
                              recording_graft):
        src = os.path.join(tmp, "resnet50.pth")
        out = os.path.join(tmp, "resnet50.pt")
        torch.save(sd, src)
        require(convert_ckpt.main(["--src", src, "--arch", "resnet50",
                                   "--out", out]) == 0, "convert_ckpt")
        converted = torch.load(out, weights_only=True)
        for ref_key, key in (("conv1.weight", "conv_stem.weight"),
                             ("layer4.2.conv3.weight",
                              "stages.3.2.conv3.weight"),
                             ("layer2.0.downsample.1.running_var",
                              "stages.1.0.down_bn.running_var")):
            require(torch.equal(converted[key], sd[ref_key]),
                    f"convert_ckpt: {key} is not {ref_key}")
        reset_launch_counts()
        t0 = time.time()
        state = cli_train.main(
            ["--dataset", "synthetic", "--eval_on", "synthetic", "--valsplit",
             "smallval", "--trainsplit", "train", "--batch_size", str(bs),
             "--test_batch_size", str(bs), "--num_epoch", "1",
             "--eval_every_epoch", "2", "--mute", "--no_vis", "--exp_key",
             "graft", "--load_backbone", out],
            log_root=os.path.join(tmp, "logs"))
        torch.cuda.synchronize()
        secs = time.time() - t0
    require(state.step == 1, f"cli.train took {state.step} steps, want 1")
    # the sanity validation batch and the step
    check_launches("cli.train --load_backbone", launch_counts(),
                   {"lbs_apply": 8, "lbs_apply_bwd": 2, "splat_fwd": 4,
                    "splat_bwd": 2}, 1)
    require(seen.get("scopes") == ["glb_backbone", "hand_backbone"],
            f"grafted scopes {seen.get('scopes')}")
    for scope in seen["scopes"]:
        for k, v in converted.items():
            require(torch.equal(seen["state"][f"net.{scope}.{k}"], v),
                    f"net.{scope}.{k} does not hold the file's tensor")
    print(f"  {len(converted)} converted tensors grafted into "
          f"{', '.join(seen['scopes'])} before the first step, bit for bit; "
          f"one step in {secs:.1f} s with the model build: ok")


def families_phase(rows, dev, tag) -> None:
    """Phase 16: HandOccNet and ArcticSF at full width, WildHands with
    ViT-B/16, HaMeR with the dense token embedding, and released
    checkpoints through the converter into ``--load_backbone``."""
    t0 = time.time()
    print(f"phase 16a: HandOccNet (leaky ResNet-50 FPN at 256^2, FIT/SET, "
          f"the hourglass regressor) {tag}")
    family_phase(rows, dev, tag, "handoccnet_light", {})
    part("16a HandOccNet")
    free = None
    for dtype, rel in (("float32", 1e-3), ("bfloat16", SERVE_REL)):
        free = tiny_grad_check("handoccnet_light", dict(
            compute_dtype=dtype, use_render_seg_loss=False), dev, rel, free)
    part("16a HandOccNet's gradient at two crops against f64")
    print(f"phase 16b: ArcticSF ({WH_BACKBONE} on the whole image, no "
          f"crops) {tag}")
    family_phase(rows, dev, tag, "arctic_sf_light",
                 {"backbone": WH_BACKBONE})
    part("16b ArcticSF")
    tiny_train_check("arctic_sf_light",
                     dict(backbone="resnet18", compute_dtype="float32"), {},
                     dev, rel=1e-3, steps=1)
    part("16b ArcticSF's step at a small size against the CPU")
    vit_b16_phase(rows, dev, tag)
    part("16c vit_b_16")
    dense_latent_phase(rows, dev, tag)
    part("16d dense_latent")
    checkpoint_phase(dev, tag)
    part("16e the converter and --load_backbone")
    print(f"phase 16 took {time.time() - t0:.1f} s")


# ---- phase 17: the serving export (cli.export), cli.extract, build_feat_split
EXPORT_HW = (512, 640)  # raw image of an exported request: make_requests' largest
EXPORT_BATCHES = {"hamer": (8, 3), "wildhands": (64, 2)}  # (images, requests)
EXPORT_ITERS = 5  # passes over the requests a timed reading
# blocks of the HaMeR exports and of the K3 package in the whole script (32
# before): the save and every load of a program, and the package's compile,
# scale with its blocks; export_alone() keeps 32
EXPORT_DEPTH = 8


def cut_serving_depth(model, per_forward, depth):
    """``model``'s ViT cut to its first ``depth`` blocks in place (widths
    stay); returns its kernel launches a forward to match ``per_forward``
    (the skinning's stay)."""
    bb = model.net.backbone
    full = len(bb.blocks)
    if depth >= full:
        return per_forward
    bb.blocks = bb.blocks[:depth]
    return {k: v if k == "lbs_apply" else v // full * depth
            for k, v in per_forward.items()}


def padded_requests(n, batch, seed):
    """:func:`make_requests`, every image zero-padded to :data:`EXPORT_HW`
    (an exported program takes one raw shape, as ``cli.demo --dir`` chunks
    do)."""
    requests = make_requests(n, batch, seed)
    for recs in requests:
        for r in recs:
            h, w = r.image.shape[:2]
            canvas = np.zeros(EXPORT_HW + (3,), np.uint8)
            canvas[:h, :w] = r.image
            r.image = canvas
    return requests


def export_input(records, spec, dev):
    """The stacked batch of ``records`` as an artifact's input
    (``input_spec`` of its sidecar), on ``dev``: zeros where the example
    records of the export had a field that requests lack (a hand mask, which
    no serving path reads)."""
    from hands_tpu_torch.data.device_pipeline import stack_records

    stacked = stack_records(records)
    extra = [k for k in stacked if not k.startswith("_") and k not in spec]
    require(not extra, f"inputs the artifact does not take: {extra}")
    raw = {}
    for k, s in spec.items():
        shape, dtype = tuple(s["shape"]), getattr(torch, s["dtype"])
        t = (torch.zeros(shape, dtype=dtype) if k not in stacked
             else torch.from_numpy(np.ascontiguousarray(stacked[k])))
        require(tuple(t.shape) == shape and t.dtype == dtype,
                f"artifact input {k}: {tuple(t.shape)} {t.dtype}, want "
                f"{shape} {dtype}")
        raw[k] = t.to(dev)
    return raw


def requests_ms(fn, requests, dev) -> float:
    """Host ms a request of ``fn(records)`` over :data:`EXPORT_ITERS` passes
    after a warm-up call, each request ending in a synchronise."""
    fn(requests[0])
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(EXPORT_ITERS):
        for recs in requests:
            fn(recs)
            torch.cuda.synchronize(dev)
    return (time.perf_counter() - t) / (EXPORT_ITERS * len(requests)) * 1e3


def artifact_check(name, path, cfg, model, per_forward, requests, dev, rel,
                   tag, package=None):
    """Load the artifact at ``path``; hold its ops, launches and outputs
    against live serving (``cli.demo.serve``) of ``model`` on the same
    requests; time both (live, artifact, artifact, live). With
    ``package`` (``{path, out}``: its outputs on the first request from the
    fresh process) also hold those outputs against live serving and time
    the package loaded here: live, artifact, package, package, artifact,
    live."""
    from hands_tpu_torch.cli import export as ex
    from hands_tpu_torch.cli.demo import serve
    from hands_tpu_torch.core.precision import f32_exact
    from hands_tpu_torch.ops.library import graph_ops

    t0 = time.time()
    program = torch.export.load(path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    ops = graph_ops(program.graph)
    run = program.module()
    load_s = time.time() - t0
    require(ops == sidecar["kernels"] and ops,
            f"{name}: loaded graph ops {ops}, sidecar {sidecar['kernels']}")
    require(sum(ops.values()) == sum(per_forward.values()),
            f"{name}: {sum(ops.values())} op nodes, live serving launches "
            f"{sum(per_forward.values())} kernels a forward")
    print(f"  {name}: loaded in {load_s:.1f} s; graph ops {ops}")

    def artifact(recs):
        with torch.no_grad(), f32_exact():
            return run(export_input(recs, sidecar["input_spec"], dev))

    artifact(requests[0])  # warm-up
    reset_launch_counts()
    out = artifact(requests[0])
    torch.cuda.synchronize(dev)
    check_launches(f"{name} artifact", launch_counts(), per_forward, 1)
    live = serve(requests[0], cfg, model, dev)
    bits = all(torch.equal(out[k], live[f"pred.{k}"]) for k in out)
    worst = max(float(((out[k].float() - live[f"pred.{k}"].float()).abs()
                       / live[f"pred.{k}"].float().abs().clamp(min=1.0)
                       ).max()) for k in out)
    print(f"  {name}: artifact vs live serving over {len(out)} outputs: "
          f"bit-equal {bits}, max |d|/max(|live|,1) {worst:.3e}")
    label = name[name.index("(") + 1:-1] if "(" in name else name
    for side in ("r", "l"):
        key = f"mano.vertices.{side}"
        compare(f"{label} artifact {key[5:]}", out[key],
                live[f"pred.{key}"], rel=rel, mean=rel)
    check_outputs([{f"pred.{k}": v for k, v in out.items()}],
                  len(requests[0]))

    def live_serve(recs):
        serve(recs, cfg, model, dev)

    crops = 2 * len(requests[0])
    if package is None:
        t = [requests_ms(live_serve, requests, dev),
             requests_ms(artifact, requests, dev),
             requests_ms(artifact, requests, dev),
             requests_ms(live_serve, requests, dev)]
        lv, ar = min(t[0], t[3]), min(t[1], t[2])
        print(f"  {name}: serve bs{len(requests[0])} ({crops} "
              f"crops/request): live {lv:.2f} ms/request "
              f"{crops / lv * 1e3:.1f} crops/s, artifact {ar:.2f} ms/request "
              f"{crops / ar * 1e3:.1f} crops/s (readings "
              f"{', '.join(f'{v:.2f}' for v in t)}) {tag}")
        return
    out = package["out"]
    bits = all(torch.equal(out[k], live[f"pred.{k}"]) for k in out)
    worst = max(float(((out[k].float() - live[f"pred.{k}"].float()).abs()
                       / live[f"pred.{k}"].float().abs().clamp(min=1.0)
                       ).max()) for k in out)
    print(f"  {name}: package (fresh process) vs live serving over "
          f"{len(out)} outputs: bit-equal {bits}, max |d|/max(|live|,1) "
          f"{worst:.3e}")
    for side in ("r", "l"):
        key = f"mano.vertices.{side}"
        compare(f"{label} package {key[5:]}", out[key], live[f"pred.{key}"],
                rel=rel, mean=rel)
    check_outputs([{f"pred.{k}": v for k, v in out.items()}],
                  len(requests[0]))
    t0 = time.time()
    run_p, _ = ex.load_artifact(package["path"])
    load_s = time.time() - t0

    def packaged(recs):
        with torch.no_grad(), f32_exact():
            return run_p(export_input(recs, sidecar["input_spec"], dev))

    t = [requests_ms(live_serve, requests, dev),
         requests_ms(artifact, requests, dev),
         requests_ms(packaged, requests, dev),
         requests_ms(packaged, requests, dev),
         requests_ms(artifact, requests, dev),
         requests_ms(live_serve, requests, dev)]
    lv, ar, pk = min(t[0], t[5]), min(t[1], t[4]), min(t[2], t[3])
    print(f"  {name}: serve bs{len(requests[0])} ({crops} crops/request): "
          f"live {lv:.2f} ms/request {crops / lv * 1e3:.1f} crops/s, "
          f"artifact {ar:.2f} ms/request {crops / ar * 1e3:.1f} crops/s, "
          f"package {pk:.2f} ms/request {crops / pk * 1e3:.1f} crops/s "
          f"(readings live, artifact, package, package, artifact, live: "
          f"{', '.join(f'{v:.2f}' for v in t)}; the package loaded here in "
          f"{load_s:.1f} s) {tag}")


def start_fresh_process(path, raw, want, tmp):
    """Start loading and running the artifact at ``path`` on ``raw`` in a
    new interpreter that imports ``torch`` and the op registrations only;
    :func:`finish_fresh_process` reads its result."""
    import os

    raw_p, want_p = os.path.join(tmp, "raw.pt"), os.path.join(tmp, "want.pt")
    torch.save(raw, raw_p)
    torch.save(want, want_p)
    code = (
        "import json, sys, torch\n"
        "import hands_tpu_torch.ops.library as L\n"
        "program = torch.export.load(sys.argv[1]).module()\n"
        "raw = torch.load(sys.argv[2], weights_only=True)\n"
        "want = torch.load(sys.argv[3], weights_only=True)\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "torch.backends.cuda.matmul."
        "allow_bf16_reduced_precision_reduction = False\n"
        "with torch.no_grad():\n"
        "    out = program(raw)\n"
        "torch.cuda.synchronize()\n"
        "from hands_tpu_torch.ops import mano_lbs, vit_block\n"
        "counts = {'vit_' + k: v for k, v in vit_block.launches.items()}\n"
        "counts.update(mano_lbs.launches)\n"
        "print(json.dumps({'launches': counts, 'equal': all(torch.equal("
        "out[k], want[k]) for k in want), 'max_diff': max(float((out[k]."
        "float() - want[k].float()).abs().max()) for k in want), "
        "'modules': sorted(m for m in sys.modules if m.startswith("
        "'hands_tpu'))}))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, path, raw_p, want_p],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.time()


def finish_fresh_process(started, per_forward) -> None:
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"fresh-process load failed:\n{err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    mods = got["modules"]
    require(not any(m.startswith(("hands_tpu_torch.models",
                                  "hands_tpu_torch.data",
                                  "hands_tpu_torch.cli")) or
                    m == "hands_tpu" or m.startswith("hands_tpu.")
                    for m in mods), f"the fresh process imported {mods}")
    for k, n in got["launches"].items():
        require(n == per_forward.get(k, 0),
                f"fresh process: {k} launched {n}, want {per_forward.get(k)}")
    print(f"  fresh `python3 -c` process (imports: {', '.join(mods)}): "
          f"loaded and ran the K3 artifact, done {time.time() - t0:.1f} s "
          f"after its start (beside the K5 and K6 exports), launches "
          f"{got['launches']}, equal to live serving {got['equal']} (max "
          f"|d| {got['max_diff']:.3e})")
    require(got["max_diff"] <= SERVE_REL,
            "fresh-process outputs far from live serving")


def op_layer_cost(cfg, model, requests, dev, tag, per_forward) -> None:
    """The host time the ``torch.library`` route adds to the direct launch
    (the eager route), in turns (direct, op, op, direct): a call of K3's
    LayerNorm on 16 rows, where the host's time and not the kernel's is
    read, scaled by the launches of a forward; then one bs8 HaMeR forward
    (its wall time, a preprocessed batch already on the card) both ways."""
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.ops import cuda_build
    from hands_tpu_torch.ops import vit_block as vb

    pre = DevicePreprocessor(cfg, is_train=False, device=dev)
    inputs, _, meta = pre(stack_records(requests[0]))
    x = torch.ones((16, C), dtype=torch.bfloat16, device=dev)
    scale = torch.ones(C, device=dev)
    bias = torch.zeros(C, device=dev)

    def forward():
        model(inputs, meta)
        torch.cuda.synchronize(dev)

    def readings(fn, iters):
        t = []
        for through_op in (False, True, True, False):
            with contextlib.ExitStack() as stack:
                if through_op:
                    stack.enter_context(mock.patch.object(
                        cuda_build, "tracing", lambda: True))
                t.append(host_ms(fn, iters=iters))
        return min(t[0], t[3]), min(t[1], t[2]), t

    with torch.inference_mode():
        cd, co, ct = readings(lambda: vb.layernorm(x, scale, bias), 2000)
        fd, fo, ft = readings(forward, 30)
    n = sum(per_forward.values())
    print(f"  op layer: a LayerNorm call (16 x {C}) direct {cd * 1e3:.2f} us,"
          f" through its op {co * 1e3:.2f} us (+{(co - cd) * 1e3:.2f} us a "
          f"call, x {n} launches a forward = {(co - cd) * n:+.3f} ms; "
          f"readings {', '.join(f'{v * 1e3:.2f}' for v in ct)} us); a bs"
          f"{len(requests[0])} HaMeR forward direct {fd:.3f} ms, through the "
          f"ops {fo:.3f} ms ({fo - fd:+.3f} ms; readings "
          f"{', '.join(f'{v:.3f}' for v in ft)}) {tag}")


def extract_check(dev, tag) -> None:
    """``cli.extract`` over the synthetic validation split (six records, one
    batch of 8) with full-width bf16 WildHands on the card, then
    ``cli.build_feat_split`` on what it wrote."""
    import os
    import tempfile

    from hands_tpu_torch.cli import build_feat_split, extract

    t0 = time.time()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_launch_counts()
            out_dir = extract.main(
                ["--method", "hands_light", "--debug", "--test_batch_size",
                 "8", "--exp_key", "smoke", "--device", dev.type],
                overrides={"backbone": WH_BACKBONE})
            torch.cuda.synchronize(dev)
            check_launches("cli.extract", launch_counts(), {"lbs_apply": 2},
                           1)
            packed = build_feat_split.main(["--eval_p", out_dir])
            data = np.load(packed, allow_pickle=True).item()
        finally:
            os.chdir(cwd)
    n = len(data["imgname"])
    keys = sorted(k for k in data if k.startswith("pred."))
    require(n == 6 and all(len(data[k]) == n and np.isfinite(data[k]).all()
                           for k in keys), f"packed split: {n} rows, {keys}")
    print(f"  cli.extract + cli.build_feat_split: {n} images, {keys} "
          f"({data['pred.feat_vec'].shape[1]}-wide feat_vec), finite, in "
          f"{time.time() - t0:.1f} s {tag}")


# the package (cli.export --aoti): the port's serving kernels as the
# profiler names them (substrings of their __global__ names)
AOTI_KERNELS = {"vit_layernorm": "layernorm_kernel",
                "vit_gemm": "BlockEpilogue",
                "vit_attention": "attention_mma_kernel",
                "lbs_apply": "lbs_kernel"}
AOTI_TIMEOUT = 600  # seconds of the fresh process that loads the packages
# what a fresh interpreter runs: the C++ ops against the Python ops' outputs,
# their refusals, a CUDA package without its ops library, then each package
# once under torch.profiler; it imports torch alone and prints a JSON report
AOTI_FRESH = r"""
import json, sys, time, torch
from torch.profiler import ProfilerActivity, profile
spec = json.load(open(sys.argv[1]))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
report = {"without_ops": ""}
try:
    run = torch._inductor.aoti_load_package(spec["without_ops"]["path"])
    report["without_ops"] = "loaded; "
    run(torch.load(spec["without_ops"]["raw"], weights_only=True))
    torch.cuda.synchronize()
except Exception as e:
    report["without_ops"] += f"{type(e).__name__}: {str(e)[:200]}"
else:
    report["without_ops"] = ""
torch.ops.load_library(spec["ops_library"])
ops = torch.ops.hands_tpu_torch_aoti
report["ops"] = []
for label, name, args, want in torch.load(spec["cases"], weights_only=True):
    got = getattr(ops, name)(*args)
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    report["ops"].append([label, len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want)), max(float(
        (g.float() - w.float()).abs().max()) for g, w in zip(got, want))])
report["refusals"] = []
for label, name, args in torch.load(spec["refusals"], weights_only=True):
    msg = ""
    try:
        getattr(ops, name)(*args)
        torch.cuda.synchronize()
    except RuntimeError as e:
        msg = str(e).splitlines()[0][:160]
    report["refusals"].append([label, msg])
report["packages"] = {}
for name, p in spec["packages"].items():
    t0 = time.time()
    run = torch._inductor.aoti_load_package(p["path"])
    load_s = time.time() - t0
    raw = torch.load(p["raw"], weights_only=True)
    with torch.no_grad():
        run(raw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = run(raw)
            torch.cuda.synchronize()
    torch.save(out, p["out"])
    report["packages"][name] = {"load_s": load_s, "kernels": [
        [e.key, e.count, e.self_device_time_total]
        for e in prof.key_averages() if e.self_device_time_total > 0]}
report["modules"] = sorted(m for m in sys.modules
                           if m.startswith("hands_tpu"))
print(json.dumps(report))
"""


def aoti_op_cases(dev):
    """The nine ops' calls at phase 17's serving shapes (3072 token rows, C
    1280, 16 heads of 80, 64 hands), every epilogue and mode, and one
    ragged case an op: ([(label, op name, args)], [refused calls])."""
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8

    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    bf, f32 = torch.bfloat16, torch.float32

    def u(*shape, dtype=bf, lo=-1.0, hi=1.0):
        t = lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
        return t.to(dtype)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    x, x32, h = u(ROWS, C), u(ROWS, C, dtype=f32), u(ROWS, HIDDEN)
    sc, bi = u(C, dtype=f32, lo=0.5, hi=1.5), u(C, dtype=f32)
    rx, rs, rb = u(77, 168), u(168, dtype=f32, lo=0.5, hi=1.5), u(168,
                                                                   dtype=f32)
    qkv, rqkv = u(BATCH, N_TOK, 3 * C), u(3, 50, 480)
    inv = u(C, dtype=f32, lo=10, hi=20)
    eps = 1e-6
    cases = [("LN", "vit_layernorm", (x, sc, bi, eps)),
             ("LN ragged 77 x 168", "vit_layernorm", (rx, rs, rb, eps)),
             ("attention", "vit_attention", (qkv, HEADS)),
             ("attention ragged (3, 50, 2 x 80)", "vit_attention",
              (rqkv, 2)),
             ("LN+quant bf16", "i8_ln_quant_dynamic", (x, sc, bi, eps)),
             ("LN+quant f32", "i8_ln_quant_dynamic", (x32, sc, bi, eps)),
             ("LN+quant ragged", "i8_ln_quant_dynamic", (rx, rs, rb, eps)),
             ("LN+quant static", "i8_ln_quant_static", (x, sc, bi, eps)),
             ("LN+quant static ragged", "i8_ln_quant_static",
              (rx, rs, rb, eps)),
             ("row quant bf16", "i8_quant_rows", (x,)),
             ("row quant f32 hidden", "i8_quant_rows",
              (u(ROWS, HIDDEN, dtype=f32),)),
             ("row quant ragged 77 x 40", "i8_quant_rows", (u(77, 40),)),
             ("attention dynamic", "qkv_attention", (qkv, HEADS, None)),
             ("attention static", "qkv_attention", (qkv, HEADS, inv)),
             ("attention dynamic ragged", "qkv_attention", (rqkv, 2, None))]
    res = u(ROWS, C)
    for label, a, n, k, resid, epi in (
            ("qkv", x, 3 * C, C, None, None),
            ("proj", x, C, C, res, "residual"),
            ("MLP1", x, HIDDEN, C, None, "gelu"),
            ("MLP1 tanh", x, HIDDEN, C, None, "gelu_tanh"),
            ("MLP2", h, C, HIDDEN, res, "residual")):
        cases.append((f"GEMM {label}", "vit_gemm",
                       (a, u(n, k, lo=-0.05, hi=0.05), u(n), resid,
                        vb._EPILOGUES[epi])))
    m, n, k, k8 = RAGGED_GEMM
    cases.append(("GEMM ragged", "vit_gemm",
                  (u(m, k), u(n, k, lo=-0.05, hi=0.05), u(n), u(m, n),
                   vb._EPILOGUES["residual"])))
    aq, hq = i8(ROWS, C), i8(ROWS, HIDDEN)
    rows_s = u(ROWS, 1, dtype=f32, lo=0.01, hi=0.02)
    for (dynamic, epi, dtype), mode in sorted(v8._GEMM_MODES.items(),
                                              key=lambda kv: kv[1]):
        cols, a = ((3 * C, aq) if epi == "bias" else (HIDDEN, aq)
                   if epi == "gelu" else (C, hq))
        resid = (u(ROWS, cols, dtype=f32 if dynamic else bf)
                 if epi == "residual" else None)
        for fast in ((False, True) if epi == "gelu" else (False,)):
            cases.append((f"int8 GEMM mode {mode}{' fast' if fast else ''}",
                          "i8_gemm",
                          (a, i8(cols, a.shape[1]),
                           u(cols, dtype=f32, lo=1e-3, hi=2e-3),
                           u(cols, dtype=f32), rows_s if dynamic else None,
                           resid,
                           u(cols, dtype=f32, lo=10, hi=20) if mode == 6
                           else None, mode, fast)))
    cases.append(("int8 GEMM ragged", "i8_gemm",
                  (i8(m, k8), i8(n, k8), u(n, dtype=f32, lo=1e-3, hi=2e-3),
                   u(n, dtype=f32), u(m, 1, dtype=f32, lo=0.01, hi=0.02),
                   u(m, n, dtype=f32), None, 1, False)))
    weights = lbs_weights(dev)
    for label, b in (("skinning 64 hands", 64), ("skinning ragged 3", 3)):
        cases.append((label, "lbs_apply",
                      (u(b, N_VERTS, 3, dtype=f32), weights,
                       u(b, 16, 4, 4, dtype=f32))))
    refusals = [("LN C 1284 (a check)", "vit_layernorm",
                 (u(13, 1284), u(1284, dtype=f32), u(1284, dtype=f32), eps)),
                ("GEMM epilogue 9 (the C entry)", "vit_gemm",
                 (x, u(C, C), u(C), None, 9))]
    return cases, refusals


def aoti_fresh_process(tmp, ops_library, packages, without_ops, dev):
    """Run :data:`AOTI_FRESH` on phase 17's op cases and on ``packages``
    ({name: {path, raw}}, each run's outputs written to a file; the one
    named ``without_ops`` is first loaded and run before the ops library
    is, which must raise); hold the
    nine C++ ops bit-equal to the Python ops (the same kernels) and both
    refusals raised on both routes. Returns the report with each package's
    outputs under ``out``."""
    cases, refusals = aoti_op_cases(dev)
    with torch.no_grad():
        want = []
        for label, name, args in cases:
            got = getattr(torch.ops.hands_tpu_torch, name)(*args)
            want.append((label, name, args, list(got) if isinstance(
                got, (tuple, list)) else [got]))
        for label, name, args in refusals:
            try:
                getattr(torch.ops.hands_tpu_torch, name)(*args)
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as err:
                print(f"  Python op {label}: refused ({str(err)[:90]})")
                continue
            raise AssertionError(f"the Python op took {label}")
    torch.cuda.synchronize()
    spec = {"ops_library": ops_library,
            "cases": os.path.join(tmp, "cases.pt"),
            "refusals": os.path.join(tmp, "refusals.pt"), "packages": {}}
    torch.save(want, spec["cases"])
    torch.save(refusals, spec["refusals"])
    del want
    for name, p in packages.items():
        raw_p = os.path.join(tmp, f"{name}_raw.pt")
        torch.save(p["raw"], raw_p)
        spec["packages"][name] = {"path": p["path"], "raw": raw_p,
                                  "out": os.path.join(tmp, f"{name}_out.pt")}
    spec["without_ops"] = spec["packages"][without_ops]
    spec_p = os.path.join(tmp, "aoti_spec.json")
    with open(spec_p, "w") as f:
        json.dump(spec, f)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", AOTI_FRESH, spec_p],
                          capture_output=True, text=True, cwd=tmp,
                          timeout=AOTI_TIMEOUT)
    require(proc.returncode == 0,
            f"the package process failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    require(report["modules"] == [],
            f"the package process imported {report['modules']}")
    require(bool(report["without_ops"]),
            "a CUDA package loaded without its ops library")
    print(f"  fresh `python3 -c` process (no hands_tpu* module; done in "
          f"{time.time() - t0:.1f} s): a package without its ops library "
          f"refused: {report['without_ops'][:120]}")
    bad = [(label, d) for label, ok, d in report["ops"] if not ok]
    print(f"  C++ ops vs Python ops, {len(report['ops'])} calls of "
          f"{len(set(n for _, n, _ in cases))} ops (serving shapes and one "
          f"ragged case an op): bit-equal {len(report['ops']) - len(bad)} of "
          f"{len(report['ops'])}" + (f"; differ: {bad}" if bad else ""))
    require(not bad, "a C++ op differs from its Python op")
    for label, msg in report["refusals"]:
        print(f"  C++ op {label}: refused ({msg[:100]})")
        require(bool(msg), f"the C++ op took {label}")
    for name, p in report["packages"].items():
        p["out"] = torch.load(spec["packages"][name]["out"],
                              map_location=dev, weights_only=True)
    return report


def package_launches(name, kernels, per_forward) -> dict:
    """The port's launches in a package's profiled run (:data:`AOTI_KERNELS`)
    held equal to live serving's ``per_forward``; prints every other kernel
    (Inductor's Triton kernels, cuBLAS, cuDNN) with its launches."""
    got = {k: sum(n for key, n, _ in kernels if sub in key)
           for k, sub in AOTI_KERNELS.items()}
    want = {k: per_forward.get(k, 0) for k in AOTI_KERNELS}
    print(f"  {name} package, launches by the profiler: {got}")
    require(got == want, f"{name} package: launches {got}, live serving "
            f"launches {want} a forward")
    others = sorted((key, n, t) for key, n, t in kernels
                    if not any(sub in key for sub in AOTI_KERNELS.values()))
    for label, group in (
            ("Inductor's (Triton)", [o for o in others
                                     if o[0].startswith("triton")]),
            ("the libraries'", [o for o in others
                                if not o[0].startswith("triton")])):
        print(f"  {name} package, {label} kernels: {len(group)}, "
              f"{sum(n for _, n, _ in group)} launches, "
              f"{sum(t for *_, t in group) / 1e3:.3f} ms of device time")
    for key, n, t in others:
        print(f"    {n:4d} x {t / max(n, 1):9.1f} us  {key[:110]}")
    return got


# runs cli.export once for each argument list of argv[1] (JSON), in turn
EXPORT_CLI = r"""
import json, sys, time
t_start = time.time()
from hands_tpu_torch.cli import export as ex
for argv in json.loads(sys.argv[1]):
    t0 = time.time()
    if ex.main(argv) != 0:
        sys.exit(1)
    print(f"  cli.export {' '.join(argv[:2])}{' --aoti' * ('--aoti' in argv)}"
          f": {time.time() - t0:.1f} s with the model build and the export",
          flush=True)
print(f"  cli.export process: done {time.time() - t_start:.1f} s after its "
      f"start", flush=True)
"""
EXPORT_CLI_TIMEOUT = 1200  # seconds of a process of EXPORT_CLI


def start_packages(dev, depth: int = EXPORT_DEPTH) -> dict:
    """Start phase 17's compiles in a new process (:data:`EXPORT_CLI`, its
    output to a file): the AOTInductor package of HaMeR K3 (the K3 serving
    model's configuration and seed, its first ``depth`` blocks), the
    WildHands artifact and package,
    in a temporary directory with Inductor's and Triton's caches inside.
    The compile is mostly one host thread, so ``main`` starts it after the
    build, it runs beside the phases up to 17, and phase 17b collects it;
    an exit kills it and removes the directory."""
    import atexit
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    bs, wbs = EXPORT_BATCHES["hamer"][0], EXPORT_BATCHES["wildhands"][0]
    raw_hw = f"{EXPORT_HW[0]}x{EXPORT_HW[1]}"
    job = {"tmp": tmp, "hamer": os.path.join(tmp, "hamer_k3_aoti.pt2"),
           "k3_artifact": os.path.join(tmp, "hamer_k3.pt2"),  # phase 17
           "artifact": os.path.join(tmp, "wildhands.pt2"),
           "wildhands": os.path.join(tmp, "wildhands_aoti.pt2"),
           "log": os.path.join(tmp, "export_cli.log"), "t0": time.time()}
    wargs = ["--method", "hands_light", "--backbone", WH_BACKBONE,
             "--dtype", "bfloat16", "--batch_size", str(wbs), "--raw_hw",
             raw_hw, "--device", dev.type]
    argvs = [["--method", "hamer_light", "--fused_block", "--batch_size",
              str(bs), "--raw_hw", raw_hw, "--device", dev.type, "--aoti",
              "--vit_depth", str(depth), "-o", job["hamer"]],
             wargs + ["-o", job["artifact"]],
             wargs + ["--aoti", "-o", job["wildhands"]]]
    env = {**os.environ,
           "TORCHINDUCTOR_CACHE_DIR": os.path.join(tmp, "inductor"),
           "TRITON_CACHE_DIR": os.path.join(tmp, "triton")}
    with open(job["log"], "w") as log:
        job["proc"] = subprocess.Popen(
            [sys.executable, "-c", EXPORT_CLI, json.dumps(argvs)],
            stdout=log, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def stop():
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)

    job["stop"] = stop
    atexit.register(stop)
    return job


def finish_packages(job) -> None:
    """Wait for :func:`start_packages`' process; print its lines."""
    proc = job["proc"]
    try:
        proc.wait(timeout=EXPORT_CLI_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(job["log"]) as f:
        out = f.read()
    require(proc.returncode == 0, f"cli.export failed:\n{out[-3000:]}")
    for line in out.splitlines():
        if line.startswith(("  cli.export", "exported")):
            print(line if line.startswith("  ") else f"  {line}")
    print(f"  the cli.export process started {job['t0'] - T_START:.1f} s "
          f"into the script, collected {time.time() - job['t0']:.1f} s after "
          f"its start: WildHands artifact "
          f"{os.path.getsize(job['artifact']) / 1e9:.3f} GB; packages HaMeR "
          f"K3 {os.path.getsize(job['hamer']) / 1e9:.3f} GB, WildHands "
          f"{os.path.getsize(job['wildhands']) / 1e9:.3f} GB")


def export_phase(configs, dev, tag, job, depth: int = EXPORT_DEPTH) -> None:
    """Phase 17: the serving program exported, saved, loaded and run
    (``cli/export.py``): HaMeR ViT-H in its three serving configurations of
    phase 3 (``configs``: K3 bf16, K5 ``quant_int8``, K6 static +
    ``fast_gelu``) at bs8, each cut to its first ``depth`` blocks (those
    models are not served again; :func:`start_packages` cuts the K3
    package alike). The K3 artifact in a fresh
    process that imports only the ops, while K5 and K6 export; their ops,
    launches and outputs against live serving, and both rates; the op
    layer's cost; ``cli.extract`` and ``cli.build_feat_split``. The K3
    artifact stays in ``job``'s directory (:func:`start_packages`, whose
    process writes the WildHands artifact and both packages) for
    :func:`package_phase`, which checks and times it beside its package."""
    import shutil
    import tempfile

    from hands_tpu_torch.cli import export as ex
    from hands_tpu_torch.cli.demo import serve

    t_phase = time.time()
    bs, n = EXPORT_BATCHES["hamer"]
    print(f"phase 17: the serving export (torch.export), HaMeR ViT-{VIT} "
          f"bs{bs} in three configurations (the first {depth} blocks), "
          f"raw {EXPORT_HW[0]}x"
          f"{EXPORT_HW[1]}, {t_phase - T_START:.0f} s into the script {tag}")
    tmp = tempfile.mkdtemp()
    fresh = None
    try:
        requests = padded_requests(n, bs, SEED + 17)
        saved = []
        for name, (cfg, model, per_forward) in configs.items():
            # the models are not served after this
            per_forward = cut_serving_depth(model, per_forward, depth)
            seen = []
            hook = model.register_forward_pre_hook(
                lambda *_: seen.append((torch.compiler.is_exporting(),
                                        torch.compiler.is_compiling())))
            path = (job["k3_artifact"] if name == K3_SERVING
                    else os.path.join(tmp, f"hamer_{len(saved)}.pt2"))
            t0 = time.time()
            program, raw, operands = ex.export_serving(cfg, model, bs,
                                                       EXPORT_HW)
            export_s = time.time() - t0
            hook.remove()
            meta = {"method": "hamer_light", "dtype": "bfloat16",
                    "fused_block": cfg.fused_block,
                    "quant_int8": cfg.quant_int8,
                    "fast_gelu": cfg.fast_gelu, "ckpt": ""}
            t0 = time.time()
            sidecar = ex.write_artifact(path, program, raw, operands, meta)
            del program, raw
            print(f"  {name}: exported in {export_s:.1f} s (under export "
                  f"is_exporting, is_compiling = {seen[0]}), saved in "
                  f"{time.time() - t0:.1f} s: {os.path.getsize(path) / 1e9:.3f}"
                  f" GB, {len(operands)} prepared int8 operands as state")
            require(bool(seen) and any(seen[0]),
                    "neither torch.compiler flag is set under export")
            require(sidecar["device"] == "cuda", "a CUDA artifact")
            saved.append((name, path, cfg, model, per_forward))
            part(f"17 {name}: export and save")
            if fresh is None:  # K3, loaded while the others export
                recs = requests[0]
                live = serve(recs, cfg, model, dev)
                fresh = (start_fresh_process(
                    path, export_input(recs, sidecar["input_spec"], dev),
                    {k[5:]: v for k, v in live.items()
                     if k.startswith("pred.")}, tmp), per_forward)
        finish_fresh_process(*fresh)
        part("17 the K3 artifact's fresh process")
        for name, path, cfg, model, per_forward in saved:
            if name == K3_SERVING:  # beside its package, phase 17b
                op_layer_cost(cfg, model, requests, dev, tag, per_forward)
            else:
                artifact_check(name, path, cfg, model, per_forward,
                               requests, dev, INT8_SERVE_REL, tag)
            part(f"17 {name}: checks and times")
        extract_check(dev, tag)
    finally:
        if fresh is not None and fresh[0][0].poll() is None:
            fresh[0][0].kill()  # a check failed before it was read
            fresh[0][0].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 17 took {time.time() - t_phase:.1f} s")


def package_phase(dev, tag, job, depth: int = EXPORT_DEPTH) -> None:
    """Phase 17b: the serving program's AOTInductor packages
    (``cli.export --aoti``) of HaMeR K3 and of WildHands bf16, compiled by
    ``job``'s process (:func:`start_packages`) since the build. A fresh
    process that imports no ``hands_tpu*`` module holds the nine C++ ops
    bit-equal to the Python ops, refuses a package without its ops library,
    and runs each package under the profiler: launches by kernel name equal
    to live serving's; outputs within the whole-forward limits of live
    serving (rebuilt: the K3 model of phase 3, the CLI's WildHands); then
    ms a request of live serving, the ``torch.export`` artifact (its ops,
    launches and bit-equal outputs held) and the package, in turns. HaMeR's
    at its first ``depth`` blocks, as :func:`start_packages` compiled it."""
    from hands_tpu_torch.cli.demo import serving_config
    from hands_tpu_torch.models.registry import fetch_model

    t_phase = time.time()
    bs, n = EXPORT_BATCHES["hamer"]
    wbs, wn = EXPORT_BATCHES["wildhands"]
    print(f"phase 17b: the serving export's AOTInductor packages, HaMeR "
          f"ViT-{VIT} K3 bs{bs} (the first {depth} blocks), WildHands {WH_BACKBONE} bf16 bs{wbs}, "
          f"{t_phase - T_START:.0f} s into the script {tag}")
    try:
        finish_packages(job)
        cfg, model, k3_forward = k3_serving(dev)
        k3_forward = cut_serving_depth(model, k3_forward, depth)
        requests = padded_requests(n, bs, SEED + 17)
        wrequests = padded_requests(wn, wbs, SEED + 170)
        packages = {}
        for name, recs, per_forward in (
                ("hamer", requests[0], k3_forward),
                ("wildhands", wrequests[0], {"lbs_apply": 2})):
            with open(job[name] + ".json") as f:
                side = json.load(f)
            require(side["format"] == "aoti" and sum(side["kernels"].values())
                    == sum(per_forward.values()) and side["ops_library"],
                    f"{name} package: sidecar {side['kernels']}")
            print(f"  {name} package: kernel ops {side['kernels']}, ops "
                  f"library {side['ops_library']} with "
                  f"{side['ops_library_files'][1:]}")
            packages[name] = {"path": job[name], "raw": export_input(
                recs, side["input_spec"], dev)}
        part("17b the compile's wait, the K3 model")
        report = aoti_fresh_process(
            job["tmp"], os.path.join(job["tmp"], side["ops_library"]),
            packages, "wildhands", dev)
        del packages
        part("17b the packages' fresh process")

        got = report["packages"]["hamer"]
        print(f"  {K3_SERVING} package: loaded in the fresh process in "
              f"{got['load_s']:.1f} s")
        package_launches("HaMeR K3", got["kernels"], k3_forward)
        artifact_check(K3_SERVING, job["k3_artifact"], cfg, model,
                       k3_forward, requests, dev, SERVE_REL, tag,
                       {"path": job["hamer"], "out": got["out"]})
        del model
        part("17b HaMeR: artifact and package against live serving")

        cfg = serving_config("hands_light", "bfloat16").replace(
            backbone=WH_BACKBONE)
        model = fetch_model(cfg, device=dev, seed=0)  # the CLI's weights
        got = report["packages"]["wildhands"]
        print(f"  WildHands bf16 package: loaded in the fresh process in "
              f"{got['load_s']:.1f} s")
        package_launches("WildHands", got["kernels"], {"lbs_apply": 2})
        artifact_check("WildHands bf16", job["artifact"], cfg, model,
                       {"lbs_apply": 2}, wrequests, dev, SERVE_REL, tag,
                       {"path": job["wildhands"], "out": got["out"]})
        del model, report
    finally:
        job["stop"]()
    print(f"phase 17b took {time.time() - t_phase:.1f} s")


# ---- phase 18: objects, ARCTIC's ground-truth build, the object metrics and
# the visualisation
ARCTIC_T = 700  # frames a sequence: ARCTIC's ~2.1 M images / 9 views / 339
ARCTIC_VIEWS = 9  # 1 egocentric + 8 fixed cameras
ARCTIC_SIZE = (2800, 2000)  # (w, h) of every view
OBJ_BATCH = 64  # templates and interaction fields a call
# frames of the sequence's fields also run on the CPU (128 before: the
# CPU's fields took 16 s)
CPU_FIELD_FRAMES = 64
VIS_IMAGES = 4  # images of the demo's request (8 before: overlays are host
# numpy, ~0.35 s a PNG)
M_TOL, PX_TOL, METRIC_REL = 1e-5, 1e-2, 1e-5
# the object metrics are differences of positions ~1 m out (roots that sum
# ~3,800 vertices in each device's order): each is held to METRIC_REL plus
# what a 1e-5 m (M_TOL) move of its points makes of it
METRIC_ABS = {"mrrpe": 2e3 * M_TOL, "cdev": 2e3 * M_TOL, "avg": 2e3 * M_TOL,
              "aae": 0.0, "acc": 4 * M_TOL * 30.0**2,
              "success_rate": 0.1}  # %: a few vertices at alpha x diameter


def raw_arctic_sequence(root, name, seed):
    """A raw ARCTIC-layout sequence ``<root>/raw_seqs/s01/<name>``
    (``mano.npy``, ``obj.npy``, ``smplx.npy``) and the subject's cameras in
    ``<root>/raw_seqs/meta/misc.json``, as ``tests/test_arctic_processing.py
    :_fake_seq`` writes them, at ARCTIC's size. Slow random walks from
    ``seed``: the object 0.5 m out in the world; the right hand on it for the
    first two thirds, then 0.3 m away; the left hand on it from T/32 to T/8;
    the body behind them; every camera 1-1.5 m back, turned by up to ~0.2
    rad, the egocam (view 0) with 8 distortion coefficients."""
    import os

    from hands_tpu_torch.core.rot import axis_angle_to_matrix

    T, views = ARCTIC_T, ARCTIC_VIEWS
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, "raw_seqs", "s01", name)
    os.makedirs(seq)

    def walk(n, step):
        return np.cumsum(rng.randn(T, n) * step, axis=0)

    t = np.arange(T)[:, None]
    obj_trans = np.float32([0.0, 0.0, 500.0]) + walk(3, 0.5)  # mm
    obj = np.concatenate([0.4 + 0.3 * np.sin(t / 60.0),
                          np.float32([0.2, -0.1, 0.3]) + walk(3, 1e-3),
                          obj_trans], axis=1).astype(np.float32)
    np.save(os.path.join(seq, "obj.npy"), obj)
    away = np.float32([0.3, 0.0, 0.0])
    on = {"right": t < 2 * T // 3, "left": (t >= T // 32) & (t < T // 8)}
    mano = {}
    for side in ("right", "left"):
        trans = obj_trans / 1000.0 + np.where(on[side], 0.0, away)
        mano[side] = {
            "rot": (rng.randn(1, 3) * 0.3 + walk(3, 1e-3)).astype(np.float32),
            "pose": (rng.randn(1, 45) * 0.2 + walk(45, 2e-4)
                     ).astype(np.float32),
            "trans": trans.astype(np.float32),
            "shape": (rng.randn(10) * 0.3).astype(np.float32),
        }
    np.save(os.path.join(seq, "mano.npy"), mano)
    body = {k: (rng.randn(T, n) * s).astype(np.float32) for k, n, s in (
        ("body_pose", 63, 0.1), ("jaw_pose", 3, 0.05), ("leye_pose", 3, 0.05),
        ("reye_pose", 3, 0.05), ("left_hand_pose", 45, 0.1),
        ("right_hand_pose", 45, 0.1))}
    body["global_orient"] = (np.float32([0.1, 0.0, 0.0]) + walk(3, 1e-3)
                             ).astype(np.float32)
    body["transl"] = (np.float32([0.0, 0.2, 0.7]) + walk(3, 1e-3)
                      ).astype(np.float32)
    np.save(os.path.join(seq, "smplx.npy"), body)

    meta = os.path.join(root, "raw_seqs", "meta")
    if not os.path.isdir(meta):
        w2c = np.tile(np.eye(4), (views, 1, 1))
        w2c[:, :3, :3] = axis_angle_to_matrix(torch.from_numpy(
            (rng.randn(views, 3) * 0.1).astype(np.float32))).numpy()
        w2c[:, :3, 3] = np.c_[rng.randn(views, 2) * 0.1,
                              1.0 + rng.rand(views) * 0.5]
        w, h = ARCTIC_SIZE
        K = np.tile(np.float32([[1200.0, 0, w / 2], [0, 1200.0, h / 2],
                                [0, 0, 1]]), (views, 1, 1))
        os.makedirs(meta)
        with open(os.path.join(meta, "misc.json"), "w") as f:
            json.dump({"s01": {
                "world2cam": w2c.tolist(), "intris_mat": K.tolist(),
                "dist8": (rng.randn(8) * [0.05, 0.01, 1e-3, 1e-3, 1e-3, 0.02,
                                          5e-3, 1e-3]).tolist(),
                "image_size": [list(ARCTIC_SIZE)] * views}}, f)
    return seq


def hold_payload(what, got, ref) -> None:
    """A ground-truth payload of the card against the CPU's: parameters and
    validity flags equal, 3D within M_TOL m, 2D and box centres within
    PX_TOL px (box scales within PX_TOL / 200)."""
    require(set(got) == set(ref) and set(got["2d"]) == set(ref["2d"])
            and set(got["cam_coord"]) == set(ref["cam_coord"]),
            f"{what}: the payloads' keys differ")
    for k in ref["params"]:
        require(np.array_equal(got["params"][k], ref["params"][k]),
                f"{what}: params {k} differ")
    d3 = max(float(np.abs(got["cam_coord"][k] - ref["cam_coord"][k]).max())
             for k in ref["cam_coord"])
    d2 = {k: float(np.abs(got["2d"][k] - ref["2d"][k]).max())
          for k in ref["2d"]}
    db = float(np.abs((got["bbox"] - ref["bbox"]) * [1, 1, 200]).max())
    flags = ("joints_valid_r", "joints_valid_l", "right_valid", "left_valid")
    moved = sum(int((got[k] != ref[k]).sum()) for k in flags)
    valid = sum(int(ref[k].sum()) for k in flags[:2])
    print(f"  {what}: cam_coord max|d| {d3:.3e} m (<= {M_TOL:g}); 2D max|d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in d2.items())
          + f" px (<= {PX_TOL:g}); boxes {db:.3e} px; {moved} validity flags "
          f"differ ({valid} valid joints)")
    require(d3 <= M_TOL and max(d2.values()) <= PX_TOL and db <= PX_TOL
            and moved == 0, f"{what}: the card's payload differs")


def hold_metric(name, got, ref) -> None:
    """A metric array of the card against the CPU's: NaN in the same places,
    the rest within METRIC_REL |ref| + its METRIC_ABS."""
    atol = METRIC_ABS[name.split("/")[0]]
    g, r = got.detach().cpu().double(), ref.double()
    fin = ~torch.isnan(r)
    d = (g[fin] - r[fin]).abs()
    excess = float((d - METRIC_REL * r[fin].abs()).max()) if d.numel() else 0.0
    ok = bool((torch.isnan(g) == ~fin).all()) and excess <= atol
    print(f"  {name:<18s} {int(fin.sum())} finite of {r.numel()}, max|d| "
          f"{float(d.max()) if d.numel() else 0.0:.3e}, max(|d| - "
          f"{METRIC_REL:g}|ref|) {excess:.3e} (<= {atol:g}), max|ref| "
          f"{float(r[fin].abs().max()):.3e}  {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: the card's metric differs from the CPU's")


def hold_field(key, d_card, i_card, d_cpu, i_cpu, query, points) -> None:
    """An interaction field of the card against the CPU's on the same
    points: distances within METRIC_REL; where the nearest point differs,
    the card's must be as near, in f64, within METRIC_REL."""
    err = float(((d_card - d_cpu).abs() / d_cpu.clamp(min=1e-9)).max())
    other = (i_card != i_cpu).nonzero(as_tuple=True)
    worst = 0.0
    if other[0].numel():
        q = query.double()[other[0], other[1]]

        def dist(i):
            return (points.double()[other[0], i[other]] - q).norm(dim=-1)
        worst = float(((dist(i_card) - dist(i_cpu)).abs()
                       / dist(i_cpu).clamp(min=1e-9)).max())
    ok = err <= METRIC_REL and worst <= METRIC_REL
    print(f"  interfield {key}: {d_cpu.numel()} distances, max rel "
          f"{err:.3e}, {other[0].numel()} other nearest points within rel "
          f"{worst:.3e} (<= {METRIC_REL:g})  {'ok' if ok else 'FAIL'}")
    require(ok, f"interfield {key}: the card's field differs from the CPU's")


def object_phase(rows, dev, tag, world) -> None:
    """Phase 18b: templates, the object set's FK, the interaction fields
    over the sequence and every object metric, card against CPU."""
    from hands_tpu_torch.core.object_tensors import (OBJECTS,
                                                     build_object_tensors,
                                                     object_forward_7d)
    from hands_tpu_torch.core.xdict import XDict
    from hands_tpu_torch.ops import mano as manolib
    from hands_tpu_torch.train import metrics_object as mo
    from hands_tpu_torch.train import process_object as po

    print(f"phase 18b: templates at batch {OBJ_BATCH}, the {len(OBJECTS)} "
          f"objects' FK, interaction fields and object metrics over "
          f"{ARCTIC_T} frames {tag}")
    cpu = torch.device("cpu")
    tensors = {d: build_object_tensors(device=d) for d in (dev, cpu)}
    for is_right in (True, False):
        reset_launch_counts()
        got = po.prepare_mano_template(
            OBJ_BATCH, manolib.load_mano(is_right, device=dev), is_right)
        torch.cuda.synchronize()
        check_launches(f"prepare_mano_template {'rl'[not is_right]}",
                       launch_counts(), {"lbs_apply": 1}, 1)
        note_launches(rows, "prepare_mano_template", launch_counts())
        ref = po.prepare_mano_template(
            OBJ_BATCH, manolib.load_mano(is_right), is_right)
        for i, (g, r) in enumerate(zip(got, ref)):
            compare_abs(f"mano template {'rl'[not is_right]} {i}", g.cpu(), r,
                        M_TOL)
    idx = torch.arange(OBJ_BATCH) % len(OBJECTS)
    got = po.prepare_object_template(OBJ_BATCH, tensors[dev], idx.to(dev))
    ref = po.prepare_object_template(OBJ_BATCH, tensors[cpu], idx)
    for name, g, r in zip(("v_sub", "parts", "v", "mask"), got, ref):
        compare_abs(f"object template {name}", g.cpu().float(), r.float(),
                    M_TOL)
    gen = torch.Generator().manual_seed(SEED)
    n = len(OBJECTS)
    args = (torch.rand((n, 1), generator=gen) * 1.5,
            torch.randn((n, 3), generator=gen) * 0.7,
            torch.randn((n, 3), generator=gen) * 100.0, torch.arange(n))
    got = object_forward_7d(tensors[dev], *(a.to(dev) for a in args))
    ref = object_forward_7d(tensors[cpu], *args)
    for k in ("v", "v_sub", "bbox3d", "kp3d"):  # mm: M_TOL m is 1e-2 mm
        compare_abs(f"object_forward_7d {k} (mm)", got[k].cpu(), ref[k],
                    M_TOL * 1000)

    # the sequence's interaction fields, 64 frames a call
    T = world["verts.right"].shape[0]
    obj = OBJECTS.index("box")
    v_len = torch.full((T,), int(tensors[dev].v_len[obj]), device=dev)
    targets = XDict({"object.v.cam": world["verts.object"],
                     "object.v_len": v_len,
                     "mano.v3d.cam.r": world["verts.right"],
                     "mano.v3d.cam.l": world["verts.left"]})
    t0 = time.perf_counter()
    fields = [po.prepare_interfield(XDict({k: v[s:s + OBJ_BATCH]
                                           for k, v in targets.items()}))
              for s in range(0, T, OBJ_BATCH)]
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    keys = [k for k in fields[0] if k.startswith(("dist.", "idx."))]
    field = {k: torch.cat([f[k] for f in fields]) for k in keys}
    t0 = time.perf_counter()
    cpu_fields = [po.prepare_interfield(XDict(
        {k: v[s:s + OBJ_BATCH].cpu() for k, v in targets.items()}))
        for s in range(0, CPU_FIELD_FRAMES, OBJ_BATCH)]
    cpu_s = time.perf_counter() - t0
    cpu_field = {k: torch.cat([f[k] for f in cpu_fields]) for k in keys}
    for s in ("r", "l"):
        hand = targets[f"mano.v3d.cam.{s}"][:CPU_FIELD_FRAMES].cpu()
        objv = targets["object.v.cam"][:CPU_FIELD_FRAMES].cpu()
        for key, query, points in ((f"{s}o", hand, objv),
                                   (f"o{s}", objv, hand)):
            hold_field(key, field[f"dist.{key}"][:CPU_FIELD_FRAMES].cpu(),
                       field[f"idx.{key}"][:CPU_FIELD_FRAMES].cpu(),
                       cpu_field[f"dist.{key}"], cpu_field[f"idx.{key}"],
                       query, points)
    print(f"  interaction fields: {T} frames on the card {card_s:.2f} s, "
          f"{CPU_FIELD_FRAMES} on the CPU {cpu_s:.2f} s {tag}")

    # the contact windows and mdev, host side, from the card's fields
    vo = (tensors[cpu].v[obj] / 1000.0).numpy()
    win = {}
    for src, fl in (("card", field), ("CPU", cpu_field)):
        win[src] = [mo.find_contact_windows(
            fl[f"dist.{s}o"][:CPU_FIELD_FRAMES].cpu().numpy(),
            fl[f"idx.{s}o"][:CPU_FIELD_FRAMES].cpu().numpy(), vo)
            for s in ("r", "l")]
    require(all(np.array_equal(a, b) for a, b in zip(win["card"], win["CPU"])),
            "contact windows of the card's fields differ from the CPU's")
    require(sum(len(w) for w in win["card"]) > 0,
            f"no contact window in the first {CPU_FIELD_FRAMES} frames")
    mdev = {}
    for s, name in (("r", "right"), ("l", "left")):
        w = mo.find_contact_windows(field[f"dist.{s}o"].cpu().numpy(),
                                    field[f"idx.{s}o"].cpu().numpy(), vo)
        mdev[name] = (len(w), mo.compute_mdev(
            world[f"verts.{name}"].cpu().numpy(),
            world["verts.object"].cpu().numpy(), w))
    print(f"  contact windows in the first {CPU_FIELD_FRAMES} frames, card "
          f"and CPU fields: {[len(w) for w in win['card']]}, equal; over "
          f"{T} frames: " + ", ".join(
              f"{k} {n} windows, mdev {v:.4f} mm" for k, (n, v) in
              mdev.items()))

    # every object metric on the sequence, card against CPU
    g = torch.Generator(device=dev).manual_seed(SEED)
    tgt = {"object.v.cam": world["verts.object"],
           "mano.v3d.cam.r": world["verts.right"],
           "mano.v3d.cam.l": world["verts.left"],
           "mano.j3d.cam.r": world["joints.right"],
           "mano.j3d.cam.l": world["joints.left"],
           "object.radian": world["object.radian"],
           "is_valid": torch.ones(T, device=dev),
           "right_valid": (torch.arange(T, device=dev) % 50 != 7).float(),
           "left_valid": (torch.arange(T, device=dev) % 70 != 3).float()}
    tgt.update(field)
    pred = {k: v + 3e-3 * torch.randn(v.shape, generator=g, device=dev)
            for k, v in tgt.items()
            if k.startswith(("object.v.", "mano.", "dist."))}
    pred["object.radian"] = tgt["object.radian"] + 0.05
    meta = {"object.v.mask": tensors[dev].mask[obj].expand(T, -1),
            "part_ids": tensors[dev].parts_ids[obj].expand(T, -1),
            "diameter": (tensors[dev].diameter[obj] / 1000.0).expand(T)}
    host = [{k: v.cpu() for k, v in d.items()} for d in (pred, tgt, meta)]
    for fn in mo.object_eval_fn_dict.values():
        got, ref = fn(pred, tgt, meta), fn(*host)
        for k in ref:
            hold_metric(k, got[k], ref[k])


def visualisation_phase(rows, dev, tag) -> None:
    """Phase 18c: ``Trainer.visualize`` on one validation batch, ``cli.demo``
    on VIS_IMAGES images with and without overlays, ``cli.sample_data`` on
    the miniature sample tree; full-width WildHands (two ResNet-50s)."""
    import glob
    import os
    import tempfile

    import cv2

    from hands_tpu_torch.cli import demo as cli_demo
    from hands_tpu_torch.cli import sample_data
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.datasets import (SyntheticRecordDataset,
                                               _read_image)
    from hands_tpu_torch.data.device_pipeline import DeviceDataLoader
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.trainer import Trainer
    from hands_tpu_torch.utils.experiment import Experiment

    print(f"phase 18c: Trainer.visualize, cli.demo overlays, "
          f"cli.sample_data; WildHands {WH_BACKBONE} x 2 {tag}")
    over = {"backbone": WH_BACKBONE}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = default_config("hands_light", logger="none", mute=True, **over)
        val = DeviceDataLoader(SyntheticRecordDataset(cfg, "val", VIS_IMAGES),
                               cfg, VIS_IMAGES, is_train=False, device=dev,
                               num_workers=0)
        trainer = Trainer(cfg, fetch_model(cfg, device=dev, seed=SEED),
                          Experiment(cfg, root=tmp))
        pushed = []
        trainer.exp.push_images = lambda images, step: pushed.append(images)
        reset_launch_counts()
        t0 = time.perf_counter()
        images = trainer.visualize(None, val, 0)
        vis_s = time.perf_counter() - t0
        # GT FK of both hands, the eval forward with its render
        check_launches("Trainer.visualize", launch_counts(),
                       {"lbs_apply": 4, "splat_fwd": 2}, 1)
        note_launches(rows, "Trainer.visualize", launch_counts())
        require(len(pushed) == 1 and pushed[0] and len(images) == 3
                and all(im.dtype == np.uint8 and im.ndim == 3
                        for _, im in images),
                f"Trainer.visualize pushed {[n for n, _ in images]}")
        print(f"  Trainer.visualize: pushed {[n for n, _ in images]} in "
              f"{vis_s:.2f} s {tag}")
        del trainer

        imgs = os.path.join(tmp, "imgs")
        os.makedirs(imgs)
        rng = np.random.RandomState(SEED)
        for i in range(VIS_IMAGES):
            cv2.imwrite(os.path.join(imgs, f"im{i}.png"), rng.randint(
                0, 256, (480 - 16 * i, 640, 3), np.uint8))
        runs = {}
        for flag, out in (([], "vis"), (["--no_vis"], "novis")):
            reset_launch_counts()
            t0 = time.perf_counter()
            require(cli_demo.main(
                ["--dir", imgs, "--batch_size", str(VIS_IMAGES), "--device",
                 str(dev), "--out", os.path.join(tmp, out)] + flag, over) == 0,
                " ".join(["cli.demo"] + flag))
            torch.cuda.synchronize()
            runs[out] = time.perf_counter() - t0
            path = " ".join(["cli.demo"] + flag)
            check_launches(path, launch_counts(), {"lbs_apply": 2}, 1)
            note_launches(rows, path, launch_counts())
        npz = {os.path.basename(p) for p in
               glob.glob(os.path.join(tmp, "novis", "*"))}
        require(npz == {f"im{i}_pred.npz" for i in range(VIS_IMAGES)},
                f"cli.demo --no_vis wrote {sorted(npz)}")
        pngs = {os.path.basename(p) for p in
                glob.glob(os.path.join(tmp, "vis", "*.png"))}
        for i in range(VIS_IMAGES):
            mine = {p for p in pngs if p.startswith(f"im{i}_{i}__")}
            require(f"im{i}_{i}__pred_kps.png" in mine and any(
                "__rend_" in p for p in mine), f"im{i}: overlays {mine}")
        require(npz <= {os.path.basename(p) for p in glob.glob(
            os.path.join(tmp, "vis", "*"))}, "cli.demo: npz with overlays")
        # a request's time, the model built and the images decoded
        scfg = cli_demo.serving_config("hands_light").replace(**over)
        model = fetch_model(scfg, device=dev, seed=SEED)
        recs = [cli_demo.make_record(p, _read_image(p)[0]) for p in
                sorted(glob.glob(os.path.join(imgs, "*.png")))]
        cli_demo.pad_to_common_size(recs)

        def request(vis):
            out, targets = cli_demo.serve_with_targets(recs, scfg, model, dev)
            torch.cuda.synchronize()
            if vis:
                require(len(cli_demo.save_overlays(
                    out, targets, scfg, recs, len(recs),
                    os.path.join(tmp, "again"))) >= 2 * len(recs),
                    "save_overlays")
        os.makedirs(os.path.join(tmp, "again"))
        request(False)
        ms = {}
        for vis in (False, True, False):
            t0 = time.perf_counter()
            request(vis)
            ms.setdefault(vis, []).append((time.perf_counter() - t0) * 1e3)
        print(f"  cli.demo, {VIS_IMAGES} images a request: "
              f"{min(ms[False]):.1f} ms a request without overlays, "
              f"{ms[True][0]:.1f} ms with ({len(pngs)} PNGs); whole CLI runs "
              f"{runs['vis']:.2f} s / {runs['novis']:.2f} s with / without "
              f"{tag}")
        del model

        trees = load_trees()
        data = os.path.join(tmp, "data")
        trees.build_sample_tree(data)
        errs = {}
        with mock.patch.dict(os.environ, {"DATA_DIR": data}), \
                contextlib.chdir(tmp):
            for device in (dev, "cpu"):
                reset_launch_counts()
                errs[str(device)] = sample_data.main(["--device",
                                                      str(device)])
                if device == dev:
                    torch.cuda.synchronize()
                    check_launches("cli.sample_data", launch_counts(),
                                   {"lbs_apply": 1}, 1)
                    note_launches(rows, "cli.sample_data", launch_counts())
        got, ref = np.asarray(errs[str(dev)]), np.asarray(errs["cpu"])
        files = glob.glob(os.path.join(tmp, "logs", "sample_data", "*.png"))
        require(len(got) == len(ref) == len(files) > 0
                and np.abs(got - ref).max() <= PX_TOL,
                f"cli.sample_data: {got} against the CPU's {ref}")
        print(f"  cli.sample_data: {len(files)} overlays, mean reprojection "
              f"errors {np.round(got, 3).tolist()} px, the CPU's within "
              f"{np.abs(got - ref).max():.2e} px")


def arctic_phase(rows, dev, tag) -> None:
    """Phase 18: ARCTIC's ground-truth build at its size on the card against
    the CPU (``process_seq`` of two sequences, ``build_split``), the object
    templates, FK, interaction fields and metrics, and the visualisation."""
    import os
    import tempfile

    from hands_tpu_torch.data import arctic_processing as ap

    t_phase = time.time()
    print(f"phase 18a: ARCTIC's ground-truth build, {ARCTIC_T} frames x "
          f"{ARCTIC_VIEWS} views of {ARCTIC_SIZE[0]} x {ARCTIC_SIZE[1]}, "
          f"MANO (K1), the object and SMPL-X {tag}")
    with tempfile.TemporaryDirectory() as tmp:
        names = ["box_grab_01", "box_use_02"]
        seqs = [raw_arctic_sequence(tmp, n, SEED + i)
                for i, n in enumerate(names)]
        secs = {"card": [], "cpu": []}
        for seq in seqs:
            for label, device in (("card", dev), ("cpu", "cpu")):
                if label == "card":
                    reset_launch_counts()
                t0 = time.perf_counter()
                ap.process_seq(seq, os.path.join(tmp, label),
                               export_verts=True, device=device)
                if label == "card":
                    torch.cuda.synchronize()
                    # one launch a hand at T samples each
                    check_launches("process_seq", launch_counts(),
                                   {"lbs_apply": 2}, 1)
                    note_launches(rows, f"process_seq T={ARCTIC_T}",
                                  launch_counts())
                secs[label].append(time.perf_counter() - t0)
        print(f"  process_seq (export_verts, SMPL-X): card "
              f"{', '.join(f'{s:.2f}' for s in secs['card'])} s, CPU "
              f"{', '.join(f'{s:.2f}' for s in secs['cpu'])} s a sequence "
              f"(the first card call builds the models) {tag}")
        split = {}
        for label in ("card", "cpu"):
            d = os.path.join(tmp, label)
            p = ap.build_split(d, [f"s01_{n}" for n in names], "p1", "train",
                               os.path.join(d, "splits"))
            split[label] = np.load(p, allow_pickle=True).item()
            for n in names:  # the sequences' files go once merged
                os.remove(os.path.join(d, f"s01_{n}.npy"))
        got, ref = split["card"], split["cpu"]
        require(got["2d"]["joints.right"].shape == (
            2 * ARCTIC_T, ARCTIC_VIEWS, 21, 2) and got["2d"][
            "verts.smplx"].shape[2] == 10475, "build_split's shapes")
        hold_payload(f"build_split of 2 x {ARCTIC_T} frames", got, ref)
        del split, got, ref

        # the world-frame FK of the first sequence feeds phase 18b
        mano = np.load(os.path.join(seqs[0], "mano.npy"),
                       allow_pickle=True).item()
        obj = torch.from_numpy(np.load(os.path.join(seqs[0], "obj.npy")))
        params = {"obj_arti": obj[:, 0], "obj_rot": obj[:, 1:4],
                  "obj_trans": obj[:, 4:7]}
        for s, name in (("r", "right"), ("l", "left")):
            for k in ("rot", "pose", "trans"):
                params[f"{k}_{s}"] = torch.from_numpy(mano[name][k])
            params[f"shape_{s}"] = torch.from_numpy(
                mano[name]["shape"]).reshape(1, 10).expand(ARCTIC_T, 10)
        world = ap.forward_gt_world({k: v.to(dev) for k, v in
                                     params.items()}, "box")
    part("18a the ground-truth build")
    object_phase(rows, dev, tag, world)
    part("18b objects")
    visualisation_phase(rows, dev, tag)
    print(f"phase 18 took {time.time() - t_phase:.1f} s")


def arctic_alone() -> int:
    """Phase 18 alone: builds K1 and K2 (the visualisation's evaluation
    forward renders its mask) and runs :func:`arctic_phase`::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.arctic_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops.cuda_build import build_all

    card = card_line()
    print_ptxas(build_all([mano_lbs.LIBRARY, ras.LIBRARY]))
    rows = {k: {"name": k} for k in ("lbs_apply", "splat_fwd")}
    arctic_phase(rows, DEV, f"[{card}]")
    print(card)
    print(json.dumps({"launches_on": {k: r.get("launches_on", {})
                                      for k, r in rows.items()}}))
    return 0


def kernel_name(mangled: str) -> str:
    """The names inside an Itanium-mangled symbol and its integer template
    arguments: enough to tell the kernels of one library apart."""
    names, i = [], 0
    while i < len(mangled):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j == i:
            i += 1
            continue
        n = int(mangled[i:j])
        name = mangled[j:j + n]
        if len(name) > 2 and not name.startswith(("_INTERNAL", "_GLOBAL",
                                                   "CUtensorMap")):
            names.append(name)
        i = j + n
    return " ".join(names + re.findall(r"Li(\d+)E", mangled))


def print_ptxas(reports) -> None:
    """The compiler's report per kernel: registers, shared memory, spills."""
    for lib, report in reports.items():
        fn = ""
        for line in report.splitlines():
            found = re.search(r"(?:entry function '|properties for )(\w+)",
                              line)
            if found:
                fn = kernel_name(found.group(1))
            elif "Used" in line or "spill" in line:
                print(f"  ptxas {lib} [{fn}]:", line.strip())


def attention_inputs(groups):
    """K3's and K5's qkv at the ViT-H shape, from the cases of
    :func:`kernel_cases`."""
    kernels = {k: v for _, _, ks in groups for k, v in ks.items()}
    return tuple(kernels[name][2][0].inputs[0]
                 for name in ("vit_attention", "qkv_attention_dynamic"))


def attention_alone() -> int:
    """The attention kernels alone: phase 2's checks at ViT-H, phase 2b, their
    times (K7's f32 route beside the CUDA-core loop it replaced), the f32
    ``fused_attn`` ViT-H backbone forward (:func:`f32_backbone_phase`), and
    K8's three attention modes at 256 crops::

        python3 -c "import chip_smoke as cs; cs.attention_alone()"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli import int8_ablation as cli
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([vb.LIBRARY, at.LIBRARY, abl.LIBRARY]))
    print(f"built {SRC_K3}, {SRC_ATTN}, {SRC_ABL} in {time.time() - t0:.1f} s")

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x, p, p32 = block_inputs(gen, DEV, BATCH, N_TOK, C, HIDDEN)
    groups, sources, _, _ = kernel_cases(x, p, p32)
    rows = {}
    check_groups(only(groups, ATTENTION_KERNELS), sources, rows)
    attention_phase(DEV, *attention_inputs(groups))
    time_groups(only(groups, ATTENTION_KERNELS), rows, tag)
    del groups, x, p, p32
    f32_backbone_phase(rows, DEV, tag)
    xa, op = cli.make_probe(ABL_BATCH, DEV, c=C, hidden=HIDDEN, n_tok=N_TOK)
    groups = only(ablation_cases(xa, op), ATTENTION_KERNELS)
    check_groups(groups, {}, rows)
    time_groups(groups, rows, tag)
    print(json.dumps({"kernels": list(rows.values())}))
    return 0


def kernels_alone() -> int:
    """The kernels of the three HaMeR serving blocks and of K7 (bf16 and f32)
    at ViT-H, 3072 rows: each against its twin, the LayerNorm at ragged
    shapes, and every launch timed through a CUDA graph beside its twin, its
    library call and its events reading; then the f32 ``fused_attn`` ViT-H
    backbone forward (:func:`f32_backbone_phase`)::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.kernels_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([vb.LIBRARY, v8.LIBRARY, at.LIBRARY]))
    print(f"built {SRC_K3}, {SRC_I8}, {SRC_ATTN} in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x, p, p32 = block_inputs(gen, DEV, BATCH, N_TOK, C, HIDDEN)
    groups, sources, _, _ = kernel_cases(x, p, p32)
    rows = {}
    check_groups(groups, sources, rows)
    layernorm_ragged_check(gen, DEV)
    time_groups(groups, rows, tag)
    del groups, x, p, p32
    f32_backbone_phase(rows, DEV, tag)
    gemm_serving_phase(gen, DEV, tag, ("vit_layernorm",))
    print(json.dumps({"kernels": list(rows.values())}))
    return 0


def rowpass_alone(check: bool = True) -> int:
    """The warp-per-row passes: K5/K6's ``ln_quant`` and K3's LayerNorm at
    ViT-H, 3072 and 24,576 rows, and K8's row and vector passes
    (``heads_split``, ``ln_affine_quant``, ``ln_cast``,
    ``heads_merge_quant``, ``cast_rows``, ``qslice_quant``) at 49,152 rows
    (256 crops), each against its twin and graph-timed beside its twin and
    its library call or yardstick; with ``check`` also at their ragged
    shapes, the narrow forms, the refused shapes and K5's block at one
    crop::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.rowpass_alone())"

    ``check=False`` times a tree from before the warp-per-row designs (no
    refusals, no narrow forms, ``ln_cast`` within one int8 step of its
    twin) behind this script.
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.cuda_build import build_all

    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([vb.LIBRARY, v8.LIBRARY, abl.LIBRARY]))
    print(f"built {SRC_K3}, {SRC_I8}, {SRC_ABL} in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x, p, p32 = block_inputs(gen, DEV, BATCH, N_TOK, C, HIDDEN)
    groups, sources, _, operands = kernel_cases(x, p, p32)
    groups = only(groups, ROW_PASSES)
    rows = {}
    check_groups(groups, sources, rows)
    if check:
        layernorm_ragged_check(gen, DEV)
        ln_quant_ragged_check(gen, DEV)
        heads_split_check(gen, DEV)
        k8_vector_check(gen, DEV)
        one_crop_check(x, operands["dynamic"])
    time_groups(groups, rows, tag)
    del groups, x, p, p32, operands
    gemm_serving_phase(gen, DEV, tag, ROW_PASSES)
    # K8 at 256 crops: tokens of the probe's magnitude with LayerNorm
    # parameters over the int8 range, the attention's f32 heads
    n_rows = ABL_BATCH * N_TOK
    qkv3 = torch.randn((ABL_BATCH, N_TOK, 3 * C), generator=gen,
                       device=DEV).to(torch.bfloat16)
    x2 = (0.5 * torch.randn((n_rows, C), generator=gen, device=DEV)).to(
        torch.bfloat16)
    ln_s = 30.0 * (1.0 + 0.1 * torch.randn(C, generator=gen, device=DEV))
    ln_b = 3.0 * torch.randn(C, generator=gen, device=DEV)
    oh = torch.randn((ABL_BATCH * HEADS, N_TOK, HEAD_DIM), generator=gen,
                     device=DEV)
    inv = 10.0 + 50.0 * torch.rand(C, generator=gen, device=DEV)
    k8 = [(K8, SRC_ABL, {"heads_split": (
        abl.heads_split, abl.heads_split_plain,
        [heads_split_case(qkv3, HEADS)]),
        **k8_row_cases(x2, ln_s, ln_b, oh, qkv3, inv, HEADS, exact=check)})]
    print(f"  K8's row passes at {n_rows} rows ({ABL_BATCH} crops)")
    check_groups(k8, {}, rows)
    time_groups(k8, rows, tag)
    print(json.dumps({"kernels": list(rows.values())}))
    return 0


def ablation_alone(iters: int = 30, wide: bool = False) -> int:
    """K8's nine modes at 256 crops through ``cli.int8_ablation`` (``iters``
    timed calls a mode, no twins) and the launch-by-launch account of
    ``full - mode``; with ``wide`` also :data:`K8_WIDE_MODES` on
    :func:`wide_probe`'s inputs, beside the probe's readings. Runs behind an
    older tree too::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.ablation_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli import int8_ablation as cli
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.cuda_build import build_all

    tag = f"[{card_line()}]"
    build_all([v8.LIBRARY, at.LIBRARY, abl.LIBRARY])
    x, op = cli.make_probe(ABL_BATCH, DEV, c=C, hidden=HIDDEN, n_tok=N_TOK)
    times = cli.run_ablation(ABL_BATCH, iters, abl.MODES, DEV, probe=(x, op),
                             heads=HEADS, out=lambda line: print("  " + line))
    ablation_account(lambda m: abl.vit_block_ablation(
        x, op, num_heads=HEADS, mode=m), times, tag)
    if wide:
        xw, opw = wide_probe(x, op, DEV)
        wide_ms = cli.run_ablation(ABL_BATCH, iters, K8_WIDE_MODES, DEV,
                                   probe=(xw, opw), heads=HEADS,
                                   out=lambda line: None)
        for mode in K8_WIDE_MODES:
            print(f"  mode {mode:9s} wide inputs {wide_ms[mode]:.3f} ms/block"
                  f", probe {times[mode]:.3f} {tag}")
        ablation_account(lambda m: abl.vit_block_ablation(
            xw, opw, num_heads=HEADS, mode=m), wide_ms, f"(wide inputs) {tag}",
            modes=K8_WIDE_MODES[1:])
        print("  zeros in mm_only's four int8 operands: probe " + ", ".join(
            f"{z:.3f}" for z in cast_chain_zeros(x, op)) + "; wide " +
            ", ".join(f"{z:.3f}" for z in cast_chain_zeros(xw, opw)))
    return 0


def gemm_alone() -> int:
    """The GEMM kernels alone (csrc/gemm_sm90.cuh): phase 2's GEMM checks at
    ViT-H (3072 rows), every epilogue off every tile, their times beside the
    library call, the serving GEMMs at 24,576 rows, and K8's three GEMM
    modes at 256 crops::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.gemm_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli import int8_ablation as cli
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([vb.LIBRARY, v8.LIBRARY, abl.LIBRARY]))
    print(f"built {SRC_K3}, {SRC_I8}, {SRC_ABL} in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x, p, p32 = block_inputs(gen, DEV, BATCH, N_TOK, C, HIDDEN)
    groups, sources, extra, _ = kernel_cases(x, p, p32)
    groups = only(groups, GEMM_KERNELS)
    rows = {}
    check_groups(groups, sources, rows)
    for case, kfn, pfn in gemm_extra(extra):
        case.check(case.label, case.call(kfn), case.call(pfn))
    gemm_ragged_check(gen, DEV)
    time_groups(groups, rows, tag)
    del groups, extra, x, p, p32
    gemm_serving_phase(gen, DEV, tag)
    xa, op = cli.make_probe(ABL_BATCH, DEV, c=C, hidden=HIDDEN, n_tok=N_TOK)
    groups = only(ablation_cases(xa, op), GEMM_KERNELS)
    check_groups(groups, {}, rows)
    time_groups(groups, rows, tag)
    print(json.dumps({"kernels": list(rows.values())}))
    return 0


def splat_alone(save=None, against=None) -> int:
    """K2 alone: builds ``csrc/splat.cu``, holds both kernels against their
    twins in every K2 case (values, gradients, the f64 twin), reads what the
    skipping rests on (:func:`splat_exactness`) and times every case beside
    its twin with both bounds. ``save``: write each case's forward (lm, mask)
    to that file; ``against``: count the values that differ from a file that
    another build of the kernels saved on the same inputs::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.splat_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops.cuda_build import build_all

    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([ras.LIBRARY, mano_lbs.LIBRARY]))
    print(f"built {SRC_SPLAT}, {SRC_LBS} in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    groups, extra, grads = geometry_cases(gen, DEV, WH_BATCHES[-1][0])
    names = ("splat_fwd", "splat_bwd")
    groups = only(groups, names)
    extra = [e for e in extra if e[1] is ras.splat_silhouette_fused]
    rows = {}
    check_groups(groups, {}, rows)
    check_extra(extra)
    for grad in grads:
        grad.release()
    splat_exactness(*splat_blob(groups))
    forwards = [c for _, _, ks in groups for k, (_, _, cs) in ks.items()
                if k == "splat_fwd" for c in cs]
    forwards += [c for c, _, _ in extra if c.label.startswith("splat fo")]
    outs = {}  # label -> the kernel's (lm, mask)
    for case in forwards:
        outs[case.label] = case.call(
            lambda v, r, s: tuple(t.cpu() for t in ras._launch_fwd(v, r, s)))
    if save:
        torch.save(outs, save)
    if against:
        other = torch.load(against)
        for label, (lm, mask) in outs.items():
            o_lm, o_mask = other[label]
            moved = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
                     for a, b in ((lm, o_lm), (mask, o_mask))]
            print(f"  {label} against {against}: {moved[0]} lm and "
                  f"{moved[1]} mask values of {lm.numel()} differ"
                  + ("  bit-equal" if not any(moved) else ""))
    time_groups(groups, rows, tag)
    time_extra(extra, tag)
    print(json.dumps({"kernels": list(rows.values())}))
    return 0


def wildhands_alone() -> int:
    """The WildHands phases alone (K1 and K2 on their paths): serving, the
    evaluation forward with render and grasp, the mask-loss gradient, the
    train and eval steps with their device time::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.wildhands_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops.cuda_build import build_all

    tag = f"[{card_line()}]"
    print_ptxas(build_all([ras.LIBRARY, mano_lbs.LIBRARY]))
    rows = {k: {} for k in ("lbs_apply", "lbs_apply_bwd", "splat_fwd",
                            "splat_bwd")}
    wildhands_phases(rows, DEV, tag)
    wildhands_train_phase(rows, DEV, tag)
    return 0


def lbs_floor(gen, tag) -> None:
    """What a launch of K1's grid costs with nothing in it: the empty kernel
    and a pass that only moves the forward's bytes (read v_posed, write
    out), each through a CUDA graph of 50 launches, at 64 and 512 hands."""
    from hands_tpu_torch.ops import mano_lbs as ml

    for b in LBS_BATCHES[:2]:
        v_posed, _ = skinning_inputs(gen, DEV, b)
        out = torch.empty_like(v_posed)
        empty = [graph_ms(lambda: ml.LIBRARY.launch("lbs_empty", DEV, b,
                                                    N_VERTS))
                 for _ in range(2)]
        copy_ms = [graph_ms(lambda: ml.LIBRARY.launch(
            "lbs_copy", DEV, v_posed.data_ptr(), out.data_ptr(), b, N_VERTS))
            for _ in range(2)]
        require(torch.equal(out, v_posed), "lbs_copy did not copy")
        print(f"  K1's floor B={b}: empty launch {min(empty):.4f} ms, "
              f"copy of its {2 * nbytes(v_posed) / 1e6:.2f} MB "
              f"{min(copy_ms):.4f} ms (a graph of 50) {tag}")


def lbs_forward_line(gen, tag) -> None:
    """The tree's ``lbs_apply`` alone at :data:`LBS_BATCHES`: held to its
    twin (``LBS_ABS``), timed through a CUDA graph of 50, and a digest of
    its output bytes (equal digests from two trees: bit-equal results).
    Uses only what the port has had since K1, so it times an older tree's
    forward too."""
    from hands_tpu_torch.ops import mano_lbs as ml

    W = lbs_weights(DEV)
    for b in LBS_BATCHES:
        v_posed, A = skinning_inputs(gen, DEV, b)
        out = ml.lbs_apply(v_posed, W, A)
        compare_abs(f"lbs_apply B={b}", out,
                    ml.lbs_apply_plain(v_posed, W, A), LBS_ABS)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = graph_ms(lambda: ml.lbs_apply(v_posed, W, A))
        print(f"  lbs_apply B={b}: {ms:.4f} ms (a graph of 50), output "
              f"sha256 {digest} {tag}")


def wildhands_step_line(tag) -> None:
    """The WildHands train step (two ResNet-50s, 64 images, the default
    config) on one synthetic batch: its launches, the best of three steps
    by events (the wall time of the step: the device waits for the host)
    and one step's device time (:func:`device_busy_ms`). Uses only what the
    port had before K1's backward kernel, so it times an older tree behind
    this script too."""
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    bs = TRAIN_WH_BATCH
    cfg = default_config("hands_light", backbone=WH_BACKBONE)
    model = fetch_model(cfg, device=DEV, seed=SEED)
    batch = make_batch(cfg, bs, seed=SEED, device=DEV)
    state = create_train_state(cfg, model)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    step = make_train_step(model, cfg)
    step(state, batch, gen)
    reset_launch_counts()
    step(state, batch, gen)
    torch.cuda.synchronize()
    k1 = {k: v for k, v in launch_counts().items() if k.startswith("lbs")}
    ms, gb = steps_ms(step, state, batch, n=3, gen=gen)
    busy, part = device_busy_ms(lambda: step(state, batch, gen),
                                names=("lbs",))
    device = "not measured" if busy is None else (
        f"{busy:.2f} ms (K1's kernels {part['lbs']:.4f} ms)")
    print(f"  hands_light train step bs{bs}: {ms:.1f} ms, device {device}, "
          f"peak +{gb:.2f} GB; K1 launches {k1} {tag}")
    del model, state, step, batch
    torch.cuda.empty_cache()


def lbs_alone(kernels: bool = True, step: bool = True) -> int:
    """K1 alone: builds ``csrc/lbs.cu`` (and ``csrc/splat.cu`` for the
    step), times the floor (:func:`lbs_floor`), holds and times both K1
    kernels at every shape of :data:`LBS_BATCHES` (the backward beside the
    path it replaced), then the WildHands train step
    (:func:`wildhands_step_line`).
    ``kernels=False``: the forward alone (:func:`lbs_forward_line`) and the
    step, for an older tree behind this script too (unpack it into
    ``_chipcheck/<x>``, copy this file in, run it there)::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.lbs_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops.cuda_build import build_all

    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([mano_lbs.LIBRARY, ras.LIBRARY]))
    print(f"built {SRC_LBS}, {SRC_SPLAT} in {time.time() - t0:.1f} s")
    if kernels:
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        lbs_floor(gen, tag)
        group, extra = lbs_cases(gen, DEV)
        rows = {}
        check_groups([group], {}, rows)
        check_extra(extra)
        time_groups([group], rows, tag)
        time_extra(extra, tag)
        print(json.dumps({"kernels": list(rows.values())}))
    else:
        lbs_forward_line(torch.Generator(device=DEV).manual_seed(SEED), tag)
    if step:
        wildhands_step_line(tag)
    return 0


def loader_alone(steps: int = 2 * LOOP_STEPS, split_batches: int = 6,
                 pcl: bool = True) -> int:
    """The training loop alone: phase 10 (``cli.train`` on the records,
    ``cli.evaluate``, the resumed epoch, the bare step) and phase 10b (the
    same epoch on the packed set, the loader's split for both loaders) with
    ``steps`` steps an epoch and the split over ``split_batches`` batches;
    then the ``pcl`` phase::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.loader_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops.cuda_build import build_all

    tag = f"[{card_line()}]"
    print_ptxas(build_all([mano_lbs.LIBRARY, ras.LIBRARY]))
    rows = {k: {} for k in ("lbs_apply", "lbs_apply_bwd", "splat_fwd",
                            "splat_bwd")}
    training_runtime_phase(rows, DEV, tag, steps=steps,
                           split_batches=split_batches)
    if pcl:
        pcl_phase(DEV, tag)
    return 0


def decompose_alone(iters: int = 10) -> int:
    """The train-step decompositions alone (``cli.train_decompose`` at HaMeR
    ViT-H bs32 and WildHands bs64), ``iters`` timed calls a row::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.decompose_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tag = f"[{card_line()}]"
    print_ptxas(build_all([vb.LIBRARY, vb.BWD_LIBRARY, mano_lbs.LIBRARY,
                           ras.LIBRARY]))
    decomposition_phase(DEV, tag, iters=iters)
    return 0


def k4_step_alone() -> int:
    """K4 on one block and in the HaMeR step: forward and backward at 3072
    and 12,288 rows a block (:func:`k4_backward_ms`), and the HaMeR ViT-H
    bs32 train step's ms and peak GB, best of two steps after a warm-up.
    Uses only what the port has had since K4, so it times an older tree
    behind this script (unpack it into ``_chipcheck/<x>``, copy this file
    in, run it from there)::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.k4_step_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.data.synthetic import make_batch
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops.cuda_build import build_all
    from hands_tpu_torch.train.state import create_train_state
    from hands_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tag = f"[{card_line()}]"
    t0 = time.time()
    # a tree from before the backward kernels has no BWD_LIBRARY
    build_all([vb.LIBRARY] + [getattr(vb, "BWD_LIBRARY", vb.LIBRARY)])
    print(f"built in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for batch in (BATCH, 2 * TRAIN_VIT_BATCH):
        x, _, p32 = block_inputs(gen, DEV, batch, N_TOK, C, HIDDEN)
        g = (torch.randn(x.shape, generator=gen, device=DEV) * 0.1).to(
            torch.bfloat16)
        k4_backward_ms(x, p32, g, tag)
        del x, p32, g
    torch.cuda.empty_cache()
    bs = TRAIN_VIT_BATCH
    cfg = default_config("hamer_light", compute_dtype="bfloat16",
                         fused_block=True, use_render_seg_loss=False, lr=1e-6)
    model = fetch_model(cfg, device=DEV, seed=SEED, vit_variant=VIT,
                        param_dtype=torch.float32)
    batch = make_batch(cfg, bs, seed=SEED, device=DEV)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    state, _ = step(state, batch, None)
    ms, gb = steps_ms(step, state, batch)
    print(f"  hamer_light train step bs{bs}, K4 (fused_block): {ms:.1f} ms "
          f"({2 * bs / ms * 1e3:.1f} crops/s), peak +{gb:.2f} GB over "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held {tag}")
    step_peaks(model, cfg, state, batch)
    return 0


def step_peaks(model, cfg, state, batch) -> None:
    """Where a train step reaches its peak: the step's parts run one by
    one as ``train.step`` runs them (the forward and losses, the
    gradients, the optimiser), each part's peak and what it leaves
    allocated, over what was held before the step (GB)."""
    from hands_tpu_torch.core.precision import f32_exact
    from hands_tpu_torch.train.step import forward_and_loss

    def mark():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    parts = []
    with f32_exact():
        torch.cuda.reset_peak_memory_stats()
        model.train()
        total, *_ = forward_and_loss(model, cfg, batch, None)
        parts.append(("forward and losses", *mark()))
        torch.cuda.reset_peak_memory_stats()
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(total, state.params, allow_unused=True),
            state.params)]
        parts.append(("gradients", *mark()))
        torch.cuda.reset_peak_memory_stats()
        state.apply_gradients(grads)
        parts.append(("optimiser", *mark()))
    print("  the step's peak by part, GB over what was held: " + "; ".join(
        f"{name} +{(peak - base) / 1e9:.4f} (then +{(now - base) / 1e9:.4f})"
        for name, peak, now in parts))


def vit_block_bwd_alone() -> int:
    """K4's backward: its three kernels against their twins at ViT-H, 3072
    and 12,288 rows, and at ragged shapes (:func:`bwd_ragged_check`),
    graph-timed beside their twins, bounds and library calls (flash
    attention's backward, ``native_layer_norm_backward``,
    ``gelu_backward``); K4's whole backward at both shapes beside what it
    ran before its kernels (:func:`k4_backward_ms`) and its account by
    kernel (:func:`k4_backward_account`)::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.vit_block_bwd_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tag = f"[{card_line()}]"
    t0 = time.time()
    print_ptxas(build_all([vb.LIBRARY, vb.BWD_LIBRARY]))
    print(f"built {SRC_K3}, {SRC_BWD} in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    bwd_ragged_check(gen, DEV)
    for batch in (BATCH, 2 * TRAIN_VIT_BATCH):
        print(f"  at {batch * N_TOK} rows ({batch} crops)")
        x, p, p32 = block_inputs(gen, DEV, batch, N_TOK, C, HIDDEN)
        groups, extra = bwd_cases(x, p, gen)
        rows = {}
        check_groups(groups, {}, rows)
        check_extra(extra)
        time_groups(groups, rows, tag, earlier=False)
        time_extra(extra, tag)
        del groups, extra
        g = (torch.randn(x.shape, generator=gen, device=DEV) * 0.1).to(
            torch.bfloat16)
        k4_ms = k4_backward_ms(x, p32, g, tag)
        k4_backward_account(x, p32, g, k4_ms["backward"], tag)
        print(json.dumps({"rows": batch * N_TOK,
                          "kernels": list(rows.values())}))
        del x, p, p32, g
        torch.cuda.empty_cache()
    return 0


def families_alone() -> int:
    """Phase 16 alone: HandOccNet and ArcticSF (serving, the evaluation
    forward, train steps, the small step against the CPU), WildHands with
    ViT-B/16 (K3 and K4 at its shapes, 168 launches a forward, a train
    step), HaMeR with ``dense_latent``, and ``--load_backbone`` on a
    converted file::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.families_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    libraries = [vb.LIBRARY, vb.BWD_LIBRARY, mano_lbs.LIBRARY, ras.LIBRARY]
    print_ptxas(build_all(libraries))
    rows = {k: {"name": k} for k in FAMILY_ROWS}
    families_phase(rows, DEV, f"[{card}]")
    print(card)
    print(json.dumps({"launches_on": {k: r.get("launches_on", {})
                                      for k, r in rows.items()}}))
    return 0


def export_alone() -> int:
    """Phases 17 and 17b alone: builds the libraries of K1, K3, K5 and K6
    (the attention's too) and the C++ ops that link them, starts the
    packages' compiles, builds the three HaMeR serving models of phase 3,
    and runs :func:`export_phase` and :func:`package_phase` at ViT-H's whole
    depth."""
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.cuda_build import build_all
    from hands_tpu_torch.ops.library import OPS_LIBRARY

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    t0 = time.time()
    build_all([vb.LIBRARY, v8.LIBRARY, at.LIBRARY, mano_lbs.LIBRARY,
               OPS_LIBRARY])
    print(f"built K1, K3, K5, K6, the attention and {SRC_OPS} in "
          f"{time.time() - t0:.1f} s")
    job = start_packages(DEV, depth=32)
    export_phase(hamer_configs(DEV), DEV, f"[{card}]", job, depth=32)
    package_phase(DEV, f"[{card}]", job, depth=32)
    print(card)
    return 0


K3_SERVING = "bf16 fused_block (K3)"


def k3_serving(dev):
    """Phase 3's bf16 ``fused_block`` HaMeR (K3) serving model, random
    weights from :data:`SEED`: (cfg, model, kernel launches per forward)."""
    from hands_tpu_torch.cli.demo import serving_config
    from hands_tpu_torch.models.registry import fetch_model

    cfg = serving_config("hamer_light", "bfloat16", fused_block=True)
    model = fetch_model(cfg, device=dev, seed=SEED, vit_variant=VIT)
    depth = len(model.net.backbone.blocks)
    # per block: LN1, LN2; qkv, proj, MLP1, MLP2; attention (224 for ViT-H);
    # per forward: the skinning of the right and of the left hand
    return cfg, model, {"vit_layernorm": 2 * depth, "vit_gemm": 4 * depth,
                        "vit_attention": depth, "lbs_apply": 2}


def hamer_configs(dev):
    """The three HaMeR ViT-H serving configurations of phase 3, built with
    random weights and the static one calibrated: {name: (cfg, model,
    kernel launches per forward)}."""
    from hands_tpu_torch.cli import calibrate as cal
    from hands_tpu_torch.cli.demo import serving_config
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.ops.calibration import inject_scales

    configs = {}  # name -> (cfg, model, launches per forward)
    t0 = time.time()
    configs[K3_SERVING] = k3_serving(dev)
    depth = len(configs[K3_SERVING][1].net.backbone.blocks)
    cfg8 = serving_config("hamer_light", "bfloat16", quant_int8=True)
    require(cfg8.fused_block and cfg8.quant_int8, "quant_int8 implies fused")
    model8 = fetch_model(cfg8, device=dev, seed=SEED, vit_variant=VIT)
    # per block: 2 LN+quant, 2 row quants, 4 GEMMs, attention (288)
    configs["quant_int8 (K5)"] = (cfg8, model8, {
        "ln_quant_dynamic": 2 * depth, "quant_rows": 2 * depth,
        "gemm_i8_dynamic": 4 * depth, "qkv_attention_dynamic": depth,
        "lbs_apply": 2})
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
        "qkv_attention_static": depth, "lbs_apply": 2})
    return configs


# ---- phase 19: data-parallel training, two ranks sharing the card
DP_RANKS = 2  # ranks on the one card (gloo: NCCL refuses two on a device)
DP_VIT_BATCH = 32  # global images of a HaMeR step: 16 a rank
DP_WH_BATCH = 32  # global images of a WildHands step
DP_STEPS = 2  # held steps; one more runs under the profiler
DP_TIMEOUT = 600.0  # seconds a launch of ranks may take
# loss and grad_norm against the one-process step at steps 1 and 2 (as the
# JAX package holds its two-process step, tests/test_multihost.py)
DP_LOSS_REL = (1e-5, 1e-4)
# HaMeR is held to the one-process step that takes the global batch in two
# row blocks (cli.parallel_check.split_step): in bf16 the kernels' products
# round per block size, so the step on the whole batch of 32 is another
# bf16 draw (2.6e-4 on the loss on an H100 at 700 W): read against it at
# tests/test_torch_train_step.py's bf16 bound on loss terms
DP_BF16_REL = 2e-2
# WildHands (f32) against the one-process step: its gradient crosses ReLU
# zeros and max-pool ties that a rounding of BatchNorm's global moments moves
# (1.5e-5 / 3.0e-5 on grad_norm on an H100; the same gradient is held at
# 1e-9 in f64 by tests/test_torch_multiprocess.py)
DP_WH_NORM_REL = 1e-4
# the two-rank ViT-H runs (global and split one-process steps, DDP, FSDP)
# took 184 s at depth 32 on an H100: past the ~120 s aimed at, so the
# phase cuts the depth; widths stay full (multiprocess_alone(32) is whole).
# 4 blocks saved nothing against 8 (the ranks' start and the steps' gloo
# copies weigh more than the blocks): 8
DP_VIT_DEPTH = 8
# FSDP's parameters after the held steps against DDP's: the share of entries
# whose updates went more than half a learning rate apart (Adam moves each
# entry by about lr, so only near-zero gradients may flip its direction; an
# update that missed its shard moves every entry)
DP_PARAMS_APART = 1e-3
DP_TRAIN_BATCH = 16  # cli.train --num_processes 2 --debug: 8 images a rank
DP_DEMO_IMAGES = 4
DP_DEVICE = "cuda"  # the ranks' device flag (a CPU rehearsal sets "cpu")
DP_OVERRIDES: dict = {}  # Config fields of the cli.train run and its demo


def dp_launch(spec: dict, out_dir: str, name: str) -> list:
    """``cli.parallel_check`` on DP_RANKS ranks of this card; returns their
    summaries (a rank that fails or outlives DP_TIMEOUT raises)."""
    from hands_tpu_torch.cli import parallel_check as pc

    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.time()
    out = pc.launch(path, os.path.join(out_dir, name), DP_RANKS,
                    ["--device", DP_DEVICE], DP_TIMEOUT)
    print(f"  {name}: {DP_RANKS} ranks ran in {time.time() - t0:.1f} s")
    return out


def dp_report(name, summaries, per_step, tag) -> dict:
    """Print each rank's step ms (host, the last held step) and the part
    of it inside collectives, the card's busy ms a step, and the memory held
    after the steps and their peak, mode by mode; require each rank's
    launches of the last held step to be ``per_step``. Returns {mode:
    launches per rank per step}."""
    launches = {}
    for mode in summaries[0]["modes"]:
        for s in summaries:
            m = s["modes"].get(mode)
            if m is None:
                continue
            def read(v, unit):
                return "not measured" if v is None else f"{v:.2f} {unit}"

            print(f"  {name} {mode} rank {s['rank']}/{s['world']}: step "
                  f"{m['step_ms']:.1f} ms host, {m['collective_ms']:.1f} of "
                  f"them in collectives; device "
                  f"{read(m['device_ms'], 'ms')} a step; held "
                  f"{read(m['held_gb'], 'GB')}, peak "
                  f"{read(m['peak_gb'], 'GB')}; parameters held "
                  f"{m['shard_bytes'] / 1e9:.3f} of "
                  f"{m['total_bytes'] / 1e9:.3f} GB {tag}")
            # the split step runs the step's kernels once a row block
            want = {k: v * (DP_RANKS if mode == "split" else 1)
                    for k, v in per_step.items()}
            require(m["launches"] == want,
                    f"{name} {mode} rank {s['rank']}: launches a step "
                    f"{m['launches']}, want {want}")
        if mode in ("ddp", "fsdp"):
            launches[mode] = dict(per_step)
    print(f"  {name}: launches a step on every rank {per_step}")
    print("  (two ranks share one card: these numbers show correctness and "
          "memory, not scaling)")
    return launches


def dp_check_steps(name, compare, pair, loss_rel=DP_LOSS_REL,
                   norm_rel=DP_LOSS_REL) -> None:
    c = compare[pair]
    for i, (lr, gr) in enumerate(zip(c["loss_rel"], c["grad_norm_rel"])):
        lim, nlim = loss_rel[i], norm_rel[i]
        print(f"  {name} {pair} step {i + 1}: loss {lr:.2e} (<= {lim:g}), "
              f"grad_norm {gr:.2e} (<= {nlim:g}) relative")
        require(lr <= lim and gr <= nlim,
                f"{name} {pair}: step {i + 1} off the one-process step")
    leaf, mx, mean = c["grads"]
    print(f"  {name} {pair}: step-1 gradient, worst leaf {leaf}: "
          f"{mx:.2e} max / {mean:.2e} mean of its largest entry")


def multiprocess_phase(rows, dev, tag, vit_depth=DP_VIT_DEPTH) -> None:
    """Phase 19: the port's data-parallel training path, two ranks of
    ``cli.parallel_check`` on this card with the gloo backend (the rule of
    ``parallel/distributed.py``): each rank brings the group up through
    ``cli.train``'s parser, places the model and steps through ``Trainer``
    and reads its rows of every global batch through the sharded loader.
    HaMeR ViT-H (K4, K1) under DDP and FSDP and full-width WildHands (K1,
    K2, BatchNorm over the global batch) under DDP, each held against the
    one-process step on the same global batch; then ``cli.train
    --num_processes 2 --debug`` and a one-process ``cli.demo --ckpt`` of
    rank 0's checkpoint, bit-equal to serving the state rank 0 held."""
    import tempfile

    from hands_tpu_torch.config import default_config
    from hands_tpu_torch.cli.parallel_check import save_batch
    from hands_tpu_torch.data.synthetic import make_batch

    print(f"phase 19: data-parallel training, {DP_RANKS} ranks on one card "
          f"(gloo) {tag}")
    # K4's forward and backward in every block and K1, as phase 7
    depth = vit_depth
    vit_step = {k: depth * (K4_FWD_LAUNCHES.get(k, 0) + n)
                for k, n in K4_BWD_LAUNCHES.items()}
    vit_step.update(K1_STEP_LAUNCHES)
    wh_step = dict(K1_STEP_LAUNCHES, splat_fwd=2, splat_bwd=2)
    with tempfile.TemporaryDirectory() as tmp:
        over = dict(compute_dtype="bfloat16", fused_block=True,
                    use_render_seg_loss=False, lr=1e-6,
                    batch_size=DP_VIT_BATCH, num_workers=0)
        spec = {"method": "hamer_light", "vit_variant": VIT,
                "vit_depth": depth, "overrides": over,
                "records": DP_VIT_BATCH, "steps": DP_STEPS,
                "modes": ["ddp", "fsdp"], "reference": ["reference", "split"]}
        print(f"  HaMeR ViT-{VIT} at full width, depth cut to {depth} "
              f"blocks, {DP_VIT_BATCH} images a global step "
              f"({DP_VIT_BATCH // DP_RANKS} a rank), bf16, fused_block, "
              f"lr 1e-6, synthetic records through the sharded loader")
        vit = dp_launch(spec, tmp, "hamer_vit")
        launches = dp_report("HaMeR", vit, vit_step, tag)
        compare = vit[0]["compare"]
        bf16 = (DP_BF16_REL,) * DP_STEPS
        for mode in ("ddp", "fsdp"):
            dp_check_steps("HaMeR", compare, f"{mode}_vs_split")
            dp_check_steps("HaMeR", compare, f"{mode}_vs_reference", bf16,
                           bf16)
        c = compare["fsdp_vs_ddp"]
        leaf, mx, mean = c["grads"]
        print(f"  HaMeR FSDP against DDP, step-1 gradients (K4 under "
              f"fully_shard), worst leaf {leaf}: {mx:.2e} max / {mean:.2e} "
              f"mean of its largest entry (<= {K4_GRAD_MAX:g} / "
              f"{K4_GRAD_MEAN:g})")
        require(mx <= K4_GRAD_MAX and mean <= K4_GRAD_MEAN,
                "HaMeR FSDP gradients off DDP's")
        leaf, mx, mean = c["params"]
        print(f"  HaMeR FSDP against DDP, parameters after step {DP_STEPS}: "
              f"{c['params_apart']:.2e} of the entries more than lr/2 apart "
              f"(<= {DP_PARAMS_APART:g}); worst leaf {leaf} {mx:.2e} of its "
              f"largest entry")
        require(c["params_apart"] <= DP_PARAMS_APART,
                "HaMeR FSDP parameters off DDP's")
        for s in vit:
            f = s["modes"]["fsdp"]
            require(f["shard_bytes"] < f["total_bytes"],
                    f"FSDP rank {s['rank']} holds no strict shard")
        mem = {(m, k): max(s["modes"][m][k] or 0.0 for s in vit)
               for m in ("ddp", "fsdp") for k in ("held_gb", "peak_gb")}
        print(f"  HaMeR ViT-{VIT} ({depth} blocks) memory a rank, held after "
              f"the steps / peak: DDP {mem['ddp', 'held_gb']:.2f} / "
              f"{mem['ddp', 'peak_gb']:.2f} GB, FSDP "
              f"{mem['fsdp', 'held_gb']:.2f} / {mem['fsdp', 'peak_gb']:.2f} "
              f"GB {tag}")
        for k in ("vit_layernorm", "vit_gemm", "vit_attention"):
            for mode, n in launches.items():
                row = rows.setdefault("vit_block_fused_trainable", {})
                per = row.setdefault("launches_per_rank_step", {})
                per[mode] = per.get(mode, 0) + n[k]
        for k in BWD_KERNELS + ("lbs_apply", "lbs_apply_bwd"):
            rows.setdefault(k, {})["launches_per_rank_step"] = {
                mode: n[k] for mode, n in launches.items()}

        wover = dict(backbone=WH_BACKBONE, compute_dtype="float32",
                     batch_size=DP_WH_BATCH, lr=1e-6, num_workers=0)
        batch_path = os.path.join(tmp, "wildhands_batch.npz")
        save_batch(batch_path, make_batch(
            default_config("hands_light", **wover), DP_WH_BATCH, seed=SEED,
            np_arrays=True))
        spec = {"method": "hands_light", "overrides": wover,
                "batch": batch_path, "steps": DP_STEPS, "modes": ["ddp"],
                "reference": True}
        print(f"  WildHands ({WH_BACKBONE} x 2, f32, mask render on), "
              f"{DP_WH_BATCH} images a global step, one make_batch batch "
              f"(noise images: synthetic records crop into constant "
              f"padding, where max-pool ties make every rounding a kink)")
        wh = dp_launch(spec, tmp, "wildhands")
        launches = dp_report("WildHands", wh, wh_step, tag)
        dp_check_steps("WildHands", wh[0]["compare"], "ddp_vs_reference",
                       norm_rel=(DP_WH_NORM_REL,) * DP_STEPS)
        spread = max(s["modes"]["ddp"]["bn_spread"] for s in wh)
        leaf, mx, _ = wh[0]["compare"]["ddp_vs_reference"]["buffers"]
        print(f"  WildHands BatchNorm running statistics: ranks apart by "
              f"{spread:.1e} (must be 0); against the one-process run after "
              f"step {DP_STEPS}, worst {leaf} {mx:.2e} of its largest entry")
        require(spread == 0.0, "the ranks' running statistics differ")
        for k in ("splat_fwd", "splat_bwd"):
            rows.setdefault(k, {})["launches_per_rank_step"] = {
                mode: n[k] for mode, n in launches.items()}
        dp_train_phase(dev, tmp, tag)


def dp_images(out_dir: str, n: int) -> str:
    """``n`` seeded noise photos (PNG, lossless) for the demo."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (240, 320, 3), np.uint8)).save(
            os.path.join(out_dir, f"photo{i}.png"))
    return out_dir


def dp_train_rank(argv) -> int:
    """A rank of phase 19's ``cli.train`` run: ``--log_root ROOT --serve
    DIR --serve_out OUT --overrides JSON`` and then ``cli.train``'s flags.
    ``--debug`` makes the batch 1 and the split ``minitrain``; the
    overrides make them DP_TRAIN_BATCH (two ranks need an even batch) and
    ``smalltrain`` (32 records: two steps). After training, rank 0 serves
    the photos of DIR in the demo's configuration with the state it holds
    and writes the predictions to OUT (``.npz``)."""
    from hands_tpu_torch.cli import demo as cli_demo
    from hands_tpu_torch.cli import train as cli_train
    from hands_tpu_torch.data.datasets import _read_image
    from hands_tpu_torch.models.registry import fetch_model
    from hands_tpu_torch.parallel import fsdp
    from hands_tpu_torch.parallel.distributed import process_index, shutdown

    argv = list(argv)
    opts = {}
    for flag in ("--log_root", "--serve", "--serve_out", "--overrides"):
        i = argv.index(flag)
        opts[flag] = argv[i + 1]
        del argv[i:i + 2]
    over = json.loads(opts["--overrides"])
    state = cli_train.main(argv, log_root=opts["--log_root"], overrides=over)
    held = {k: fsdp.full(fsdp.local(v), v)
            for k, v in state.model.state_dict().items()}
    if process_index() == 0:
        dev = state.params[0].device
        scfg = cli_demo.serving_config("hands_light", "bfloat16").replace(
            **{k: v for k, v in over.items() if k == "backbone"})
        model = fetch_model(scfg, device=dev, seed=SEED)
        own = model.state_dict()
        model.load_state_dict({k: v for k, v in held.items() if k in own})
        paths = sorted(glob.glob(os.path.join(opts["--serve"], "*.png")))
        recs = [cli_demo.make_record(p, _read_image(p)[0]) for p in paths]
        out = cli_demo.serve(recs, scfg, model, dev).to_np()
        np.savez(opts["--serve_out"], **{
            k: out[k] for k in out
            if k.startswith("pred.mano.") or k == "pred.feat_vec"})
    shutdown()
    return 0


def dp_train_phase(dev, tmp, tag) -> None:
    """``cli.train --num_processes 2 --debug`` (WildHands at full width, one
    epoch of synthetic records, 8 images a rank a step), each rank a process
    of this script; then ``cli.demo --ckpt`` in this one process on rank 0's
    checkpoint, bit-equal to what rank 0 served with the state it held."""
    from hands_tpu_torch.cli import demo as cli_demo
    from hands_tpu_torch.parallel.launch import free_port, run_ranks

    photos = dp_images(os.path.join(tmp, "photos"), DP_DEMO_IMAGES)
    root = os.path.join(tmp, "dp_logs")
    served = os.path.join(tmp, "rank0_served.npz")
    address = f"localhost:{free_port()}"
    over = dict(DP_OVERRIDES, batch_size=DP_TRAIN_BATCH,
                test_batch_size=DP_TRAIN_BATCH, trainsplit="smalltrain")
    cmds = [[sys.executable, os.path.abspath(__file__), "--dp-train-rank",
             "--log_root", root, "--serve", photos, "--serve_out", served,
             "--overrides", json.dumps(over),
             "--debug", "--eval_every_epoch", "1", "--no_vis", "--mute",
             "--device", DP_DEVICE,
             "--num_processes", str(DP_RANKS), "--process_id", str(r),
             "--coordinator_address", address] for r in range(DP_RANKS)]
    t0 = time.time()
    outs = run_ranks(cmds, DP_TIMEOUT,
                     cwd=os.path.dirname(os.path.abspath(__file__)))
    print(f"  cli.train --num_processes {DP_RANKS} --debug: one epoch in "
          f"{time.time() - t0:.1f} s of processes {tag}")
    for r, out in enumerate(outs):
        line = [ln for ln in out.splitlines()
                if ln.startswith("multi-process:")]
        device = "cuda:0" if DP_DEVICE == "cuda" else DP_DEVICE
        require(len(line) == 1 and "backend gloo" in line[0]
                and f"device {device}" in line[0], f"rank {r} startup: {line}")
        print(f"  rank {r}: {line[0]}")
    keys = os.listdir(root)
    require(len(keys) == 1, f"the ranks wrote {keys}, want one experiment")
    ckpts = os.path.join(root, keys[0], "checkpoints")
    require(sorted(f for f in os.listdir(ckpts) if not f.endswith(".json"))
            == ["epoch_0000", "last"], f"checkpoints {os.listdir(ckpts)}")
    demo_out = os.path.join(tmp, "demo")
    require(cli_demo.main(["--dir", photos, "--dtype", "bfloat16",
                           "--batch_size", str(DP_DEMO_IMAGES),
                           "--device", DP_DEVICE, "--no_vis", "--out",
                           demo_out, "--ckpt",
                           os.path.join(ckpts, "last")],
                          {k: v for k, v in over.items()
                           if k == "backbone"}) == 0,
            "cli.demo --ckpt")
    want = np.load(served)
    n_equal = n_keys = 0
    for i, p in enumerate(sorted(glob.glob(os.path.join(photos, "*.png")))):
        stem = os.path.splitext(os.path.basename(p))[0]
        got = np.load(os.path.join(demo_out, f"{stem}_pred.npz"))
        for k in got.files:
            n_keys += 1
            n_equal += int(np.array_equal(got[k], want[k][i]))
    print(f"  one-process cli.demo --ckpt of rank 0's checkpoint: {n_equal} "
          f"of {n_keys} prediction arrays bit-equal to rank 0 serving the "
          f"state it held")
    require(n_keys > 0 and n_equal == n_keys,
            "the checkpoint does not serve rank 0's state")


def multiprocess_alone(vit_depth: int = DP_VIT_DEPTH) -> int:
    """Phase 19 alone: builds K1, K2, K3 and K4's backward and runs
    :func:`multiprocess_phase` (``vit_depth=32``: ViT-H whole, ~3 min
    more)::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.multiprocess_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer as ras
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops.cuda_build import build_all

    card = card_line()
    print_ptxas(build_all([vb.LIBRARY, vb.BWD_LIBRARY, mano_lbs.LIBRARY,
                           ras.LIBRARY]))
    rows = {}
    multiprocess_phase(rows, DEV, f"[{card}]", vit_depth)
    print(card)
    print(json.dumps({"launches_per_rank_step": {
        k: r["launches_per_rank_step"] for k, r in rows.items()}}))
    return 0


# ---- phase 22: the model-parallel axes, two ranks sharing the card
TP_REQUESTS, TP_IMAGES = 3, 4  # TP serving: three requests of 8 crops
TP_TRAIN_DEPTH = 8  # the TP train steps' ViT-H depth (phase 19's)
TP_TRAIN_BATCH = 16  # images of a TP train step, every rank all of them
SP_IMAGES = 8  # crops of the SP backbone: 96 tokens a rank
SP_ATTENTION = (8, N_TOK, HEADS, HEAD_DIM)  # the ring's and SP's f32 check
SP_ATTN_ABS = 2e-5  # against mha_reference, the JAX tests' f32 limit
# the ringed backbone's features (after the last LayerNorm, unit scale)
# against the one-rank ring: the f32 sums of the online softmax differ in
# the last bits, which flip bf16 roundings of the projections' inputs, and 32
# plain bf16 blocks with random weights amplify the flips. The largest entry
# is held at about twice the largest of ring_witness_alone()'s bf16 readings
# at depth 32 (an H100, four seeds; f32 and depth 2 there show the gap is
# rounding), the mean at SERVE_REL
SP_BACKBONE_MAX = 5e-2
PP_MICROBATCHES, PP_CROPS = 4, 8  # M microbatches of 8 crops, 2 stages
# a TP step's launches a block on each rank: K4's forward with proj and MLP2
# as the f32 partial GEMM, the recompute (its proj likewise), the backward
# kernels; the model axis' all-reduces (2 forward, 1 recompute, 2 input
# gradients)
TP_BLOCK_STEP = {"vit_layernorm": 4, "vit_gemm": 4, "vit_gemm_f32": 3,
                 "vit_attention": 2, "attention_bwd": 1, "layernorm_bwd": 2,
                 "layernorm_bwd_sums": 2, "gelu_bwd": 1,
                 "model_all_reduce": 5}


def mp_report(part, summaries, want, tag) -> None:
    """Print each rank's readings of ``part`` (a mode of
    ``cli.parallel_check``) and require its launches of a call or step to
    be ``want``."""
    def read(v, unit):
        return "not measured" if v is None else f"{v:.2f} {unit}"

    for sm in summaries:
        m = sm["modes"].get(part)
        if m is None:
            continue
        print(f"  {part} rank {sm['rank']}/{sm['world']}: "
              f"{m['step_ms']:.1f} ms a call, {m['collective_ms']:.1f} of "
              f"them in collectives; device {read(m['device_ms'], 'ms')} a "
              f"call; held {read(m['held_gb'], 'GB')}, peak "
              f"{read(m['peak_gb'], 'GB')}; parameters "
              f"{m['shard_bytes'] / 1e9:.3f} of {m['total_bytes'] / 1e9:.3f} "
              f"GB {tag}")
        require(m["launches"] == want, f"{part} rank {sm['rank']}: launches "
                f"{m['launches']}, want {want}")
    print(f"  {part}: launches a call on every rank {want}")


def model_parallel_phase(rows, dev, tag) -> None:
    """Phase 22: the model-parallel axes on two ranks of ``cli.parallel_check``
    sharing this card through gloo, each held against its one-process
    counterpart: (a) HaMeR ViT-H at full depth, bf16 ``fused_block``, under
    ``shard_vit_tp`` (K3 on each rank's 8 heads, proj and MLP2 as the f32
    partial GEMM summed over the ranks), serving three requests; (b) its
    train steps at phase 19's depth through ``make_train_step`` (K4's
    backward with the column-parallel input gradients summed); (c) the plain
    bf16 backbone with ``ring`` (each rank 96 of the 192 tokens), and
    ``sp_attention`` / ``ring_attention`` at ViT-H's shape in f32; (d)
    ``pipeline_apply`` over two stages of 16 K3 blocks."""
    import tempfile

    t_phase = time.time()
    depth = 32 if VIT == "h" else 2
    print(f"phase 22: model-parallel axes, {TP_RANKS} ranks on one card "
          f"(gloo), {t_phase - T_START:.0f} s into the script {tag}")
    print("  (two ranks share one card: correctness and memory, not "
          "scaling)")
    over = dict(compute_dtype="bfloat16", fused_block=True,
                use_render_seg_loss=False, lr=1e-6,
                batch_size=TP_TRAIN_BATCH, num_workers=0)
    spec = {"method": "hamer_light", "vit_variant": VIT, "overrides": over,
            "records": TP_TRAIN_BATCH, "steps": DP_STEPS,
            "mode_depth": {"tp": TP_TRAIN_DEPTH,
                           "reference": TP_TRAIN_DEPTH},
            "images": TP_IMAGES, "requests": TP_REQUESTS,
            "sp_images": SP_IMAGES, "attention": SP_ATTENTION,
            "pp_crops": PP_CROPS, "microbatches": PP_MICROBATCHES,
            "modes": ["tp_serve", "tp", "sp", "pp"],
            "reference": ["serve", "reference", "backbone", "serial"]}
    with tempfile.TemporaryDirectory() as tmp:
        out = dp_launch(spec, tmp, "model_parallel")
    compare = out[0]["compare"]

    # (a) TP serving
    per = {"vit_layernorm": 2 * depth, "vit_gemm": 2 * depth,
           "vit_gemm_f32": 2 * depth, "vit_attention": depth,
           "lbs_apply": 2, "model_all_reduce": 2 * depth}
    print(f"  (a) HaMeR ViT-{VIT} (depth {depth}), bf16 fused_block, "
          f"{TP_REQUESTS} requests of {2 * TP_IMAGES} crops, tensor "
          f"parallel: each rank {HEADS // TP_RANKS} heads and "
          f"{HIDDEN // TP_RANKS} hidden columns")
    mp_report("tp_serve", out, per, tag)
    one = {"vit_layernorm": 2 * depth, "vit_gemm": 4 * depth,
           "vit_attention": depth, "lbs_apply": 2}
    mp_report("serve", out, one, tag)
    print(f"  the model axis' all-reduces a forward: {2 * depth} (proj and "
          f"MLP2 of each block, f32); K3's launches a rank: vit_gemm "
          f"{2 * depth} + vit_gemm_f32 {2 * depth} = one process's "
          f"{4 * depth}")
    c = compare["tp_serve_vs_serve"]
    print(f"  TP serving against the one-process K3 serve: worst "
          f"{c['worst']} {c['max']:.2e} max / {c['mean']:.2e} mean of "
          f"max(|ref|, 1) (<= {SERVE_REL:g})")
    require(c["max"] <= SERVE_REL and c["mean"] <= SERVE_REL,
            "TP serving off the one-process serve")
    held = out[0]["modes"]["tp_serve"]["launches_held"]
    rows["vit_gemm_f32"]["launches"] = held.get("vit_gemm_f32", 0)
    for k in ("vit_layernorm", "vit_gemm", "vit_attention", "vit_gemm_f32"):
        rows[k].setdefault("launches_per_rank", {})[
            "tp_serve (a forward)"] = per[k]

    # (b) TP train steps
    step = {k: TP_TRAIN_DEPTH * n for k, n in TP_BLOCK_STEP.items()}
    step.update(K1_STEP_LAUNCHES)
    print(f"  (b) HaMeR ViT-{VIT} at depth {TP_TRAIN_DEPTH}, "
          f"{TP_TRAIN_BATCH} images a step on every rank, K4 tensor "
          f"parallel, lr 1e-6")
    mp_report("tp", out, step, tag)
    bf16 = (DP_BF16_REL,) * DP_STEPS
    dp_check_steps("HaMeR", compare, "tp_vs_reference", bf16, bf16)
    label = f"tp step (depth {TP_TRAIN_DEPTH})"
    for k in ("vit_layernorm", "vit_gemm", "vit_attention",
              "vit_gemm_f32") + BWD_KERNELS:
        rows[k].setdefault("launches_per_rank", {})[label] = step[k]

    # (c) SP
    print(f"  (c) the plain bf16 ViT-{VIT} backbone (depth {depth}), "
          f"{SP_IMAGES} crops, ring over {TP_RANKS} ranks: "
          f"{N_TOK // TP_RANKS} tokens a rank, the ring's attention in f32")
    mp_report("sp", out, {}, tag)  # plain modules: no kernel of the port
    hops = 2 * depth * (TP_RANKS - 1)  # K and V, each block's ring
    hop_mb = SP_IMAGES * (N_TOK // TP_RANKS) * C * 4 / 1e6  # an f32 block
    sp_ms = max(sm["modes"]["sp"]["collective_ms"] for sm in out)
    print(f"  the ring's hop (ppermute) is an all_gather of which a rank "
          f"keeps its source's block, not a gloo send/recv: {hops} hops a "
          f"forward of {hop_mb:.2f} MB each ({TP_RANKS}x that gathered), and "
          f"the final token all_gather; {sp_ms:.1f} ms of collectives a "
          f"forward, {sp_ms / (hops + 1):.2f} ms a collective {tag}")
    c = compare["sp_vs_backbone"]
    print(f"  ringed backbone against the one-process backbone (a ring of "
          f"one rank: the same f32 attention unsharded): {c['max']:.2e} max "
          f"(<= {SP_BACKBONE_MAX:g}) / {c['mean']:.2e} mean (<= "
          f"{SERVE_REL:g}) of max(|ref|, 1)")
    require(c["max"] <= SP_BACKBONE_MAX and c["mean"] <= SERVE_REL,
            "the ringed backbone off the one-process backbone")
    for sm in out:
        m = sm["modes"]["sp"]
        print(f"  rank {sm['rank']}: sp_attention {m['sp_attention']:.2e}, "
              f"ring_attention {m['ring_attention']:.2e} max abs against "
              f"mha_reference at {SP_ATTENTION} f32 (<= {SP_ATTN_ABS:g})")
        require(m["sp_attention"] <= SP_ATTN_ABS
                and m["ring_attention"] <= SP_ATTN_ABS,
                f"rank {sm['rank']}: sequence-parallel attention")

    # (d) PP
    stage = depth // TP_RANKS
    pp = {"vit_layernorm": 2 * stage * PP_MICROBATCHES,
          "vit_gemm": 4 * stage * PP_MICROBATCHES,
          "vit_attention": stage * PP_MICROBATCHES}
    print(f"  (d) {depth} K3 blocks in {TP_RANKS} stages of {stage}, "
          f"{PP_MICROBATCHES} microbatches of {PP_CROPS} crops (bubble ticks "
          f"skipped: each stage runs its blocks once a microbatch)")
    mp_report("pp", out, pp, tag)
    mp_report("serial", out, {k: v * TP_RANKS for k, v in pp.items()}, tag)
    c = compare["pp_vs_serial"]
    print(f"  pipeline against the blocks applied serially: "
          f"{'bit-equal' if c['equal'] else 'NOT bit-equal'} (max "
          f"{c['max']:.2e})")
    require(c["equal"], "the pipeline is not bit-equal to the serial blocks")
    for k in pp:
        rows[k]["launches_per_rank"][
            f"pp ({TP_RANKS} stages, M {PP_MICROBATCHES})"] = pp[k]
    print(f"phase 22 took {time.time() - t_phase:.1f} s")


# the ringed backbone against the one-rank ring, by ring_witness_alone():
# (seed, dtype, depth) of the backbone; the f32 and shallow runs show the
# bf16 reading's gap is rounding
RING_WITNESS = ((0, "bfloat16", 32), (1, "bfloat16", 32),
                (2, "bfloat16", 32), (3, "bfloat16", 32),
                (0, "float32", 32), (0, "bfloat16", 2))


def ring_witness_alone() -> int:
    """Phase 22(c)'s ringed backbone against the one-rank ring on
    :data:`RING_WITNESS`' seeds, dtypes and depths, one launch of two ranks
    each::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.ring_witness_alone())"
    """
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    readings = []
    for seed, dtype, depth in RING_WITNESS:
        spec = {"method": "hamer_light", "vit_variant": VIT,
                "overrides": {"seed": seed}, "vit_depth": depth,
                "sp_images": SP_IMAGES, "sp_dtype": dtype,
                "modes": ["sp"], "reference": ["backbone"], "profile": False}
        with tempfile.TemporaryDirectory() as tmp:
            c = dp_launch(spec, tmp, f"ring_{dtype}_{depth}_{seed}")[0][
                "compare"]["sp_vs_backbone"]
        print(f"  ringed backbone, seed {seed}, {dtype}, depth {depth}: "
              f"{c['max']:.3e} max / {c['mean']:.3e} mean of max(|ref|, 1) "
              f"[{card}]")
        readings.append({"seed": seed, "dtype": dtype, "depth": depth,
                         "max": c["max"], "mean": c["mean"]})
    print(card)
    print(json.dumps({"ring_witness": readings}))
    return 0


def tp_alone() -> int:
    """Phase 22 alone, with phase 2's checks and times of the kernels at the
    tensor-parallel local shapes: builds K1, K3 and K4's backward::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.tp_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    tag = f"[{card}]"
    print_ptxas(build_all([vb.LIBRARY, vb.BWD_LIBRARY, mano_lbs.LIBRARY]))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    x, p, _ = block_inputs(gen, DEV, BATCH, N_TOK, C, HIDDEN)
    k3, _, _ = k3_cases(x, p, HEADS)
    groups, extra = tp_kernel_cases(x, p)
    groups = [(K3, SRC_K3, k3)] + groups
    rows = {}
    check_groups(groups, {}, rows)
    check_extra(extra)
    time_groups(groups, rows, tag)
    time_extra(extra, tag)
    for k in BWD_KERNELS:
        rows[k] = {"name": k}
    model_parallel_phase(rows, DEV, tag)
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    return 0


# ---- phase 20: the serving ladder on weights trained here (cli.trained_accuracy)
# train steps of phase 20 on the fresh-draw stream: 300 before; cut for
# phase 22's time, where the descent still reads 2.01x (an H100: windows of
# 50 steps at 1.47e5, 2.0e3, 621; 3.5x at 300)
TA_STEPS = 150
TA_LONG_STEPS = 1500  # the long ladder of trained_accuracy_alone
TA_BATCH = 16  # images a step: 32 crops
TA_PREDRAWN = 10  # timed steps on batches drawn beforehand


def counting_hook(seen: dict):
    """A ``hook(name)`` for the parts of phases 20 and 21: the launch counts
    set to 0 as a part starts, read into ``seen[name]`` as it ends."""

    @contextlib.contextmanager
    def hook(name):
        reset_launch_counts()
        yield
        torch.cuda.synchronize()
        seen[name] = launch_counts()

    return hook


def predrawn_steps(ta, cfg, model, state, dev, n: int = TA_PREDRAWN):
    """The train step of the stream on ``n`` + 1 of its batches drawn and
    copied to the card beforehand, so that no draw thread runs beside the
    steps: (ms a step, the step's call in ms a step) over the last ``n``,
    host clock ending in a synchronise."""
    from hands_tpu_torch.train.step import make_train_step

    draws = ta.FreshDraws(cfg, n + 1, TA_BATCH, dev)
    batches = [draws.device_batch(b, None, None)
               for b, _ in draws.host_batches(None)]
    step = make_train_step(model, cfg)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    t0, call = time.perf_counter(), 0.0
    for batch in batches[1:]:
        t = time.perf_counter()
        state, _ = step(state, batch)
        call += time.perf_counter() - t
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, call / n * 1e3


def trained_accuracy_phase(rows, dev, tag, steps: int = TA_STEPS,
                           min_descent: float = 1.0) -> dict:
    """Phase 20: ``cli.trained_accuracy``'s parts, each with its launches
    counted. HaMeR ViT-H at full width and depth: the untrained weights on
    the held-out batches, ``steps`` steps of ``TA_BATCH`` images on fresh
    synthetic draws through K4 (bf16, lr 5e-5, clip 1.0), the same step on
    batches drawn beforehand (no draw thread), then
    the four rungs (K3, K5, K5 + tanh GELU, K6 calibrated on the eval
    batches) on the two held-out batches of 32. Each part's launches are
    exact; the loss is finite and its descent (the first loss over the last
    window's mean) above ``min_descent``; every ladder row is finite."""
    from hands_tpu_torch.cli import trained_accuracy as ta
    from hands_tpu_torch.models.registry import fetch_model

    t_phase = time.time()
    print(f"phase 20: cli.trained_accuracy, ViT-{VIT} HaMeR, {steps} steps "
          f"of {TA_BATCH} fresh images, then the serving ladder on 2 x "
          f"{ta.EVAL_BATCH} held-out images, {t_phase - T_START:.0f} s into "
          f"the script {tag}")
    seen = {}
    hook = counting_hook(seen)
    cfg = ta.train_cfg(fused_block=True)
    eval_batches = ta.eval_batches_for(cfg, dev)
    model = fetch_model(cfg, device=dev, seed=ta.INIT_SEED, vit_variant=VIT,
                        param_dtype=torch.float32)
    with hook("untrained"):
        untrained, _ = ta.eval_rung("untrained (seed 0), bf16", cfg, model,
                                    eval_batches)
    try:
        with hook("train"):
            state, trained = ta.train(cfg, model, steps, TA_BATCH, dev)
    except FloatingPointError as err:
        require(False, f"trained_accuracy: {err}")
    part(f"20 the untrained rung, {steps} steps")
    state_dict = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    with hook("predrawn"):
        pre_ms, pre_call_ms = predrawn_steps(ta, cfg, model, state, dev)
    del state, model
    torch.cuda.empty_cache()
    part("20 the steps on batches drawn beforehand")
    ladder, ref = [], None
    for name, kw in ta.LADDER:
        rcfg, rmodel = ta.rung_model(kw, state_dict, eval_batches, VIT, dev)
        with hook(name):
            rung_rows, outs = ta.eval_rung(name, rcfg, rmodel, eval_batches,
                                           ref)
        ref = outs if ref is None else ref
        ladder.append({"rung": name, "rows": rung_rows})
        del rmodel
        torch.cuda.empty_cache()

    depth = 32 if VIT == "h" else 2
    per_step = {k: depth * (K4_FWD_LAUNCHES.get(k, 0) + n)
                for k, n in K4_BWD_LAUNCHES.items()}
    per_step.update(K1_STEP_LAUNCHES)
    check_launches("trained_accuracy train", seen["train"], per_step, steps)
    check_launches("trained_accuracy predrawn steps", seen["predrawn"],
                   per_step, TA_PREDRAWN + 1)
    note_launches(rows, "cli.trained_accuracy train", seen["train"])
    # a batch: the eval step (GT and forward skin twice each) and the
    # forward of the drift (twice more): two block forwards, 6 skinnings
    forwards = 2 * len(ta.EVAL_SEEDS)
    k3 = {"vit_layernorm": 2 * depth, "vit_gemm": 4 * depth,
          "vit_attention": depth, "lbs_apply": 3}
    k5 = {"ln_quant_dynamic": 2 * depth, "quant_rows": 2 * depth,
          "gemm_i8_dynamic": 4 * depth, "qkv_attention_dynamic": depth,
          "lbs_apply": 3}
    k6 = {"ln_quant_static": 2 * depth, "gemm_i8_static": 4 * depth,
          "qkv_attention_static": depth, "lbs_apply": 3}
    check_launches("trained_accuracy untrained", seen["untrained"], k3,
                   forwards)
    for name, kw in ta.LADDER:
        per = (k6 if kw.get("quant_int8_static") else
               k5 if kw.get("quant_int8") else k3)
        check_launches(f"trained_accuracy {name}", seen[name], per, forwards)
        note_launches(rows, f"cli.trained_accuracy {name}", seen[name])

    losses, curve = trained["losses"], trained["loss_curve"]
    require(all(math.isfinite(v) for v in losses) and curve
            and trained["descent"] > min_descent,
            f"trained_accuracy: the loss fell {trained['descent']:.2f}x, "
            f"not above {min_descent:g}x ({losses[0]:.3f} at the first "
            f"step, windows {curve})")
    for rung in ladder:
        require(len(rung["rows"]) == len(ta.EVAL_SEEDS) and all(
            math.isfinite(v) for r in rung["rows"] for v in r.values()),
            f"trained_accuracy: ladder rows of {rung['rung']}")
    # an int8 rung that quantised nothing would read the bf16 rung's joints
    require(all(r["drift_mean_mm"] > 0 for rung in ladder[1:]
                for r in rung["rows"]),
            "trained_accuracy: an int8 rung with no drift against bf16")
    print(f"  loss {losses[0]:.3f} at step 1, means of each "
          f"{ta.LOG_EVERY} steps " + ", ".join(f"{m:.3f}" for _, m in curve)
          + f"; descent {trained['descent']:.2f}x (the JAX tool asks for "
          f"{ta.DESCENT:g}x; below it the ladder runs on weights that "
          f"barely trained); {trained['ms_per_step']:.2f} ms a step (host "
          f"clock; the step's call {trained['call_ms_per_step']:.2f}, the "
          f"wait for the batch {trained['wait_ms_per_step']:.2f}), device "
          f"{trained['device_ms_per_step']:.2f} ms a step over the last "
          f"{trained['busy_steps']} (profiler; "
          f"{1 - trained['device_ms_per_step'] / trained['ms_per_step']:.1%}"
          f" idle) {tag}")
    print(f"  the same step on {TA_PREDRAWN} batches drawn beforehand (no "
          f"draw thread): {pre_ms:.2f} ms a step, the step's call "
          f"{pre_call_ms:.2f} {tag}")

    def pix(rows_):
        return ", ".join(f"{r['pix_err/h']:.2f}" for r in rows_)

    print(f"  held-out pix_err/h (px, batches A, B): untrained "
          f"{pix(untrained)}, trained (bf16 rung) {pix(ladder[0]['rows'])} "
          f"{tag}")
    for rung in ladder[1:]:
        print(f"  {rung['rung']}: j3d drift against bf16 (mm, mean / max) "
              + ", ".join(f"{r['drift_mean_mm']:.3f} / "
                          f"{r['drift_max_mm']:.3f}" for r in rung["rows"])
              + f" {tag}")
    print(f"phase 20 took {time.time() - t_phase:.1f} s")
    trained.update(predrawn_ms_per_step=pre_ms,
                   predrawn_call_ms_per_step=pre_call_ms)
    return {"metric": "trained_accuracy", "vit": VIT, "steps": steps,
            "batch": TA_BATCH, "untrained": untrained, "trained": trained,
            "ladder": ladder}


def trained_accuracy_alone(steps: int = TA_LONG_STEPS,
                           min_descent: float | None = None) -> int:
    """Phase 20 alone, by default the long ladder, which holds the loss's
    descent to the JAX tool's 5x (``min_descent``; None: ``DESCENT``):
    builds K1, K3 with K4's backward, K5 and K6, and runs
    :func:`trained_accuracy_phase`::

        python3 -c "import sys, chip_smoke as cs;
            sys.exit(cs.trained_accuracy_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli import trained_accuracy as ta
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print_ptxas(build_all([vb.LIBRARY, vb.BWD_LIBRARY, v8.LIBRARY,
                           at.LIBRARY, mano_lbs.LIBRARY]))
    rows = {k: {"name": k} for k in launch_counts()}
    out = trained_accuracy_phase(
        rows, DEV, f"[{card}]", steps,
        ta.DESCENT if min_descent is None else min_descent)
    print(card)
    out["trained"].pop("losses")
    print(json.dumps(out))
    return 0


# ---- phase 21: the EPIC-scale evaluation sweep (cli.eval_sweep)
SWEEP_N = 5000  # packed records: EPIC-HandKps' 5,000 images
SWEEP_RECORDS_N = 512  # records of the record route (images made per fetch)
# the sweep in the whole script (5,000 and 512 records, then 1,000, before;
# eval_sweep_alone keeps EPIC-5000): 4 batches of 128, the last one padded
# (116 real rows)
SWEEP_MAIN_N, SWEEP_MAIN_RECORDS_N = 500, 256
SWEEP_BS = 128  # the reference's test batch


def eval_sweep_phase(rows, dev, tag, n: int = SWEEP_N,
                     n_records: int = SWEEP_RECORDS_N) -> dict:
    """Phase 21: ``cli.eval_sweep``, full-width WildHands (two ResNet-50s,
    224^2 crops, bf16) through ``DeviceDataLoader`` (``drop_last=False``)
    and ``Trainer.validate``: ``n`` packed records and ``n_records``
    records, batches of ``SWEEP_BS``. Every eval step launches K1 four
    times (the forward and the GT processing skin both hands), the loader
    alone none; the epochs agree, the padded tail is NaN."""
    from hands_tpu_torch.cli import eval_sweep

    t_phase = time.time()
    print(f"phase 21: cli.eval_sweep, WildHands ({WH_BACKBONE}, bf16), {n} "
          f"packed records and {n_records} records in batches of "
          f"{SWEEP_BS}, {t_phase - T_START:.0f} s into the script {tag}")
    outs = {}
    for packed, count in ((True, n), (False, n_records)):
        route = "packed" if packed else "records"
        seen = {}
        try:
            out = eval_sweep.sweep(count, SWEEP_BS, "hands_light", packed,
                                   dev, hook=counting_hook(seen),
                                   backbone=WH_BACKBONE)
        except RuntimeError as err:
            require(False, f"eval_sweep {route}: {err}")
        for name in ("epoch 1", "epoch 2", "epoch 3"):
            check_launches(f"eval_sweep {route} {name}", seen[name],
                           {"lbs_apply": 4}, out["batches"])
        check_launches(f"eval_sweep {route} loader alone", seen["loader"],
                       {}, 1)
        note_launches(rows, f"cli.eval_sweep {route} epoch",
                      seen["epoch 2"])
        pad = SWEEP_BS - out["tail_rows"]
        rows_ = out["tail"]
        require(all(np.isnan(v[out["tail_rows"]:]).all()
                    for v in rows_.values()) and
                np.isfinite(rows_["pix_err/h"][:out["tail_rows"]]).all(),
                f"eval_sweep {route}: the padded tail")
        device = ("not measured" if out["device_ms"] is None else
                  f"{out['device_ms']:.1f} ms of device time an epoch ("
                  f"{1 - out['device_ms'] / 1e3 / out['epoch2_s']:.1%} idle)")
        print(f"  {route}, {count} records ({out['batches']} batches, the "
              f"last {pad} rows padded, NaN in every metric): build "
              f"{out['build_s']:.2f} s, epoch 1 {out['epoch1_s']:.2f} s, "
              f"epoch 2 {out['epoch2_s']:.2f} s = {out['value']:.1f} "
              f"samples/s, {device}, loader alone {out['loader_s']:.2f} s; "
              f"pix_err/h {out['metrics']['metric.pix_err/h']:.3f} px {tag}")
        outs[route] = out
    print(f"phase 21 took {time.time() - t_phase:.1f} s")
    return outs


def eval_sweep_alone(n: int = SWEEP_N, n_records: int = SWEEP_RECORDS_N
                     ) -> int:
    """Phase 21 alone: builds K1 and runs :func:`eval_sweep_phase`::

        python3 -c "import sys, chip_smoke as cs; sys.exit(cs.eval_sweep_alone())"
    """
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops.cuda_build import build_all

    card = card_line()
    print_ptxas(build_all([mano_lbs.LIBRARY]))
    rows = {"lbs_apply": {"name": "lbs_apply"}}
    outs = eval_sweep_phase(rows, DEV, f"[{card}]", n, n_records)
    print(card)
    print(json.dumps({route: {k: v for k, v in out.items()
                              if k not in ("epochs", "tail")}
                      for route, out in outs.items()}))
    return 0


PHASE_S: dict = {}  # seconds of each part of main, in order
_LAP = [T_START]
_PART = [T_START]


def lap(name: str) -> None:
    """Note the seconds since the previous lap (the script's start) as part
    ``name`` of :data:`PHASE_S`."""
    now = time.time()
    PHASE_S[name] = round(now - _LAP[0], 1)
    _LAP[0] = _PART[0] = now


def part(label: str) -> None:
    """Print the seconds since the previous :func:`part` or :func:`lap`:
    where a phase's time goes."""
    now = time.time()
    print(f"  [{label}: {now - _PART[0]:.1f} s]")
    _PART[0] = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hands_tpu_torch.cli import calibrate as cal
    from hands_tpu_torch.cli.demo import serve
    from hands_tpu_torch.data.device_pipeline import (DevicePreprocessor,
                                                      stack_records)
    from hands_tpu_torch.models.backbones import vit as vit_mod
    from hands_tpu_torch.models.registry import fetch_model, init_weights_
    from hands_tpu_torch.ops import attention as at
    from hands_tpu_torch.ops import mano_lbs
    from hands_tpu_torch.ops import rasterizer
    from hands_tpu_torch.ops import vit_block as vb
    from hands_tpu_torch.ops import vit_block_int8 as v8
    from hands_tpu_torch.ops.calibration import inject_scales
    from hands_tpu_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = DEV
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {tag}")
    decoder = decoder_probe()

    # ---- 1. build: one nvcc per source, all started together
    t0 = time.time()
    from hands_tpu_torch.ops import vit_block_ablation as abl
    from hands_tpu_torch.ops.library import OPS_LIBRARY
    libraries = [vb.LIBRARY, v8.LIBRARY, at.LIBRARY, mano_lbs.LIBRARY,
                 rasterizer.LIBRARY, abl.LIBRARY, vb.BWD_LIBRARY]
    # the C++ ops (g++ on PyTorch's headers) link the first four: last
    reports = build_all(libraries + [OPS_LIBRARY])
    for lib in libraries:
        lib.lib()
    print(f"phase 1: built {SRC_K3}, {SRC_I8}, {SRC_ATTN}, {SRC_LBS}, "
          f"{SRC_SPLAT}, {SRC_ABL}, {SRC_BWD} and {SRC_OPS} side by side in "
          f"{time.time() - t0:.1f} s")
    print_ptxas(reports)
    packages = start_packages(dev)  # phase 17b's compiles, beside 2-18
    lap("1 build")

    # ---- 2. each kernel against its twin at ViT-H shapes
    print(f"phase 2: kernels vs twins, rows={ROWS} C={C} hidden={HIDDEN} "
          f"heads={HEADS} D={HEAD_DIM}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, p, p32 = block_inputs(gen, dev, BATCH, N_TOK, C, HIDDEN)
    groups, sources, extra, operands = kernel_cases(x, p, p32)
    tp_groups, tp_extra = tp_kernel_cases(x, p)  # phase 22's local shapes
    groups += tp_groups
    extra += tp_extra
    wh_batch = WH_BATCHES[-1][0]  # hands per MANO decode and per render
    print(f"  K1 and K2 at {wh_batch} hands, {N_VERTS} vertices, render "
          f"{RENDER_RES}^2, sigma {RENDER_SIGMA} px")
    geo_groups, geo_extra, splat_grads = geometry_cases(gen, dev, wh_batch)
    groups += geo_groups
    extra += geo_extra
    rows = {}  # kernel name -> its line of the kernels JSON
    check_groups(groups, sources, rows)
    check_extra(extra)
    for grad in splat_grads:
        grad.release()  # the twin's graph holds the (B, P, V) pair tensors
    splat_exactness(*splat_blob(groups))
    part("2 the kernels against their twins")

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
    one_crop_check(x, operands["dynamic"])
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
    attention_phase(dev, *attention_inputs(groups))
    layernorm_ragged_check(gen, dev)
    ln_quant_ragged_check(gen, dev)
    heads_split_check(gen, dev)
    k8_vector_check(gen, dev)
    gemm_ragged_check(gen, dev)
    lap("2 kernels vs twins")

    # ---- 3. serve requests through full-width ViT-H, kernels on
    requests = make_requests(3, 8, SEED)
    forwards = len(requests)
    twins = {
        "vit_block_fused_trainable":
            lambda x, params, num_heads, fast_gelu=False:
            vb.vit_block_plain(x.to(torch.bfloat16), vb._cast_params(params),
                               num_heads, fast_gelu),
        "vit_block_fused_int8": lambda x, op, num_heads, fast_gelu=False:
            v8.vit_block_int8_plain(x, op, num_heads, fast_gelu),
        "vit_block_fused_int8_static":
            lambda x, op, num_heads, fast_gelu=False:
            v8.vit_block_int8_static_plain(x, op, num_heads, fast_gelu),
    }

    def twin_path():
        """Every block kernel of the model swapped for its plain twin."""
        return mock.patch.multiple(vit_mod, **twins)

    configs = hamer_configs(dev)
    depth = len(configs["bf16 fused_block (K3)"][1].net.backbone.blocks)

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
    f32_backbone_phase(rows, dev, tag)

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
    lap("3 serving")

    # ---- 4. timing
    print(f"phase 4: CUDA-event times {tag}")
    time_groups(groups, rows, tag)
    time_extra(extra, tag)
    part("4 the kernels' times")
    lbs_floor(gen, tag)
    # what the twin of K2 costs in memory: it stores the (B, P, V) tensors
    from hands_tpu_torch.ops import rasterizer as ras
    fwd_case = groups[-1][2]["splat_fwd"][2][0]
    bwd_case = groups[-1][2]["splat_bwd"][2][0]
    for grad in splat_grads:
        grad.release()
    for label, fn in (("kernels", ras.splat_silhouette_fused),
                      ("twin", ras.splat_silhouette_plain)):
        f_gb = twin_memory(lambda: fwd_case.call(fn))
        b_gb = twin_memory(lambda: bwd_case.call(fn))
        splat_grads[0].release()
        print(f"  splat {label}: peak memory of a forward {f_gb:.3f} GB, of a "
              f"forward kept for its backward plus the backward {b_gb:.3f} "
              f"GB {tag}")
    for name, (kern, twin) in blocks.items():
        t = [cuda_ms(twin), cuda_ms(kern), cuda_ms(kern), cuda_ms(twin)]
        print(f"  whole {name} (rows {ROWS}): kernels {min(t[1], t[2]):.4f} "
              f"ms, twin {min(t[0], t[3]):.4f} ms {tag}")
    part("4 K1's floor, K2's memory, the whole blocks")
    gemm_serving_phase(gen, dev, tag)
    part("4 the GEMMs at serving shapes")

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
    part("4 the model forwards")

    for bs, nb in ((8, 4), (64, 2)):
        batches = make_requests(nb, bs, SEED + bs)
        for name, (c, m, _) in configs.items():
            k_rate, k_ms = serve_rate(batches, c, m, dev)
            with twin_path():
                t_rate, t_ms = serve_rate(batches, c, m, dev)
            k_rate2, k_ms2 = serve_rate(batches, c, m, dev)
            print(f"  {name}: serve bs{bs} ({2 * bs} crops/request): kernels "
                  f"{max(k_rate, k_rate2):.1f} crops/s "
                  f"({min(k_ms, k_ms2):.2f} ms/request), twin {t_rate:.1f} "
                  f"crops/s ({t_ms:.2f} ms/request) {tag}")

    lap("4 timing")
    export_phase(configs, dev, tag, packages)
    lap("17 export")
    wildhands_phases(rows, dev, tag)
    lap("5 WildHands")
    # the serving models go before the train steps read the memory they add
    del configs, served, c, m
    torch.cuda.empty_cache()
    trainable_block_phase(rows, x, p32, tag)
    lap("6 K4")
    hamer_train_phase(rows, dev, tag)
    lap("7 HaMeR steps")
    wildhands_train_phase(rows, dev, tag)
    lap("8 WildHands steps")
    ablation_phase(rows, dev, tag)
    lap("9 K8 ablation")
    training_runtime_phase(rows, dev, tag)
    lap("10 cli.train")
    pcl_phase(dev, tag)
    lap("11 pcl")
    decomposition_phase(dev, tag)
    lap("12 decompositions")
    real_layout_phase(dev, tag, decoder)
    lap("13 real layouts")
    learning_phase(dev, tag)
    lap("14 learning")
    int8_drift_phase(dev, tag)
    lap("15 int8 drift")
    families_phase(rows, dev, tag)
    lap("16 families")
    arctic_phase(rows, dev, tag)
    lap("18 ARCTIC")
    package_phase(dev, tag, packages)
    lap("17b packages")
    multiprocess_phase(rows, dev, tag)
    lap("19 data parallel")
    trained_accuracy_phase(rows, dev, tag)
    lap("20 trained ladder")
    eval_sweep_phase(rows, dev, tag, SWEEP_MAIN_N, SWEEP_MAIN_RECORDS_N)
    lap("21 eval sweep")
    model_parallel_phase(rows, dev, tag)
    lap("22 model parallel")

    print(f"seconds by part: {json.dumps(PHASE_S)}; the whole "
          f"{time.time() - T_START:.1f} s {tag}")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-train-rank"]:
        sys.exit(dp_train_rank(sys.argv[2:]))
    sys.exit(main())
