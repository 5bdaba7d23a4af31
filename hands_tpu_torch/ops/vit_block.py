"""Fused ViT block: hand-written CUDA kernels plus their plain PyTorch twin
(port of ``hands_tpu/ops/vit_block_pallas.py:vit_block_fused``).

One pre-LN block in bf16 — LN1 -> qkv -> attention -> proj + residual ->
LN2 -> MLP1 + GELU -> MLP2 + residual — with the rounding points of the JAX
package's ``block_math`` / ``_vit_block_kernel``. On Hopper the block's ~39
MB of ViT-H weights cannot stay on-chip, so ``csrc/vit_block.cu`` splits it
into three kernels (LayerNorm, bf16 GEMM with epilogues, per-head attention),
launched seven times per block; see the note at the top of that file.

Each wrapper (:func:`layernorm`, :func:`gemm`, :func:`attention`) launches
its kernel for CUDA tensors and counts the launch in :data:`launches`; for
CPU tensors it runs its ``*_plain`` twin. Nothing falls back silently: a
tensor on any other device, or one the kernel does not take, raises. The
three forward kernels are also the ops ``hands_tpu_torch::vit_layernorm``,
``vit_gemm`` and ``vit_attention`` (``cuda_build.KernelOp``), which a
``torch.export`` of the block records.

:func:`vit_block_fused_trainable` (port of the JAX function of that name) is
the block for training: the same seven launches forward, and a backward that
keeps only the block's input and parameters (:func:`vit_block_backward`). It
recomputes the block through the same kernels up to the MLP's pre-GELU
activation, takes the gradient products with ``torch.matmul``, and runs the
attention, LayerNorm and GELU backward through three more kernels
(``csrc/vit_block_bwd.cu``: :func:`attention_bwd`, :func:`layernorm_bwd`,
:func:`gelu_bwd`, counted in :data:`bwd_launches`). Their twins
(``*_bwd_plain``) are autograd of the forward twins written out op by op,
so on the CPU the backward is bit for bit autograd of
:func:`vit_block_plain`.

The shared libraries are built with ``nvcc`` at first use
(:mod:`hands_tpu_torch.ops.cuda_build`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from hands_tpu_torch.ops.cuda_build import CudaLibrary, KernelOp
from hands_tpu_torch.ops.cuda_build import check as _check
from hands_tpu_torch.ops.cuda_build import check_gemm_operands
from hands_tpu_torch.ops.cuda_build import on_cpu as _on_cpu

_EPILOGUES = {None: 0, "gelu": 1, "residual": 2, "gelu_tanh": 3}
_BF16 = torch.bfloat16

# kernel launches per wrapper since the last reset (CPU twin runs not
# counted); gemm_f32 is the GEMM's f32 partial-product form (gemm_partial)
launches: Dict[str, int] = {"layernorm": 0, "gemm": 0, "gemm_f32": 0,
                            "attention": 0}
# the same for the backward's kernels; layernorm_bwd_sums is the second
# launch of layernorm_bwd (the column sums of its blocks' partial sums)
bwd_launches: Dict[str, int] = {"attention_bwd": 0, "layernorm_bwd": 0,
                                "layernorm_bwd_sums": 0, "gelu_bwd": 0}


def reset_launches() -> None:
    for counts in (launches, bwd_launches):
        for k in counts:
            counts[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vit_layernorm.argtypes = [i, p, p, p, p, i, i, f, p]
    lib.vit_gemm.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    lib.vit_gemm_f32.argtypes = [i, p, p, p, i, i, i, p]
    lib.vit_attention.argtypes = [i, p, p, i, i, i, i, f, p]
    for fn in (lib.vit_layernorm, lib.vit_gemm, lib.vit_gemm_f32,
               lib.vit_attention):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("vit_block", _bind, "vit_error_string")


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.vbb_attention_bwd.argtypes = [i, p, p, p, i, i, i, i, f, p]
    lib.vbb_layernorm_bwd.argtypes = [i, p, p, p, p, p, p, i, i, i, f, p]
    lib.vbb_column_sums.argtypes = [i, p, p, i, i, p]
    lib.vbb_gelu_bwd.argtypes = [i, p, p, p, p, ll, i, p]
    for fn in (lib.vbb_attention_bwd, lib.vbb_layernorm_bwd,
               lib.vbb_column_sums, lib.vbb_gelu_bwd):
        fn.restype = ctypes.c_int


BWD_LIBRARY = CudaLibrary("vit_block_bwd", _bind_bwd, "vbb_error_string")


# csrc/attention_kernel.cuh: a row of logits stays in registers
ATTN_MAX_N, ATTN_MAX_D = 256, 128
# csrc/common.cuh (WARP_ROW_MAX_C): a row of the LayerNorm kernels (this
# block's and the int8 blocks' ln_quant) stays in one warp's registers
LN_MAX_C = 2048


def check_layernorm_width(C: int) -> None:
    """Raise unless the LayerNorm kernels (this block's and ``ln_quant``)
    take rows of ``C`` channels: a multiple of 8 (aligned vectors of 4
    values) up to :data:`LN_MAX_C`."""
    if C % 8 or not 8 <= C <= LN_MAX_C:
        raise ValueError(f"LayerNorm kernel needs a width that is a multiple "
                         f"of 8 up to {LN_MAX_C} (vectors of 4 values, the "
                         f"row in one warp's registers), got {C}")


def check_attention_shape(N: int, D: int) -> None:
    """Raise unless the attention kernel takes ``N`` tokens with head dim
    ``D``: D a multiple of 16 up to :data:`ATTN_MAX_D`, N up to
    :data:`ATTN_MAX_N`."""
    if D % 16 or not 16 <= D <= ATTN_MAX_D:
        raise ValueError(f"attention kernel needs a head dim that is a "
                         f"multiple of 16 up to {ATTN_MAX_D}, got {D}")
    if not 1 <= N <= ATTN_MAX_N:
        raise ValueError(f"attention kernel takes 1 to {ATTN_MAX_N} tokens "
                         f"(a row of logits in registers), got {N}")


def bf16_const(v: float) -> float:
    """``v`` rounded to bf16, as JAX rounds a weak-typed scalar that meets a
    bf16 array."""
    return float(torch.tensor(v, dtype=_BF16))


# ------------------------------------------------------------- plain twins
def layernorm_f32(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm`` in f32 to its rounding order (port of
    ``_layernorm_f32``): fast variance ``max(E[x^2] - E[x]^2, 0)`` and
    ``mul = rsqrt(var + eps) * scale`` applied as one multiplier."""
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.clamp(
        torch.mean(x32 * x32, dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (x32 - mu) * mul + bias


def gelu_erfc(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU ``0.5x * erfc(-x/sqrt2)`` with every op rounded to
    ``x.dtype`` and the constant rounded first (jax.nn.gelu's exact form;
    in bf16 the rounding points of ``_gelu_mosaic``)."""
    sqrt_half = float(torch.tensor(2.0**-0.5, dtype=x.dtype))
    half_x = x * 0.5
    d = (-x) * sqrt_half
    e = torch.special.erfc(d.float()).to(x.dtype)
    return half_x * e


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU ``x * 0.5 * (1 + tanh(c * (x + 0.044715 x^3)))``
    with every op rounded to ``x.dtype`` and the constants rounded first
    (``jax.nn.gelu(approximate=True)``, the fast form of ``_gelu_mosaic``)."""
    c = float(torch.tensor((2.0 / np.pi) ** 0.5, dtype=x.dtype))
    k = float(torch.tensor(0.044715, dtype=x.dtype))
    x3 = x * (x * x)
    inner = c * (x + k * x3)
    t = torch.tanh(inner.float()).to(x.dtype)
    return x * (0.5 * (1.0 + t))


def gelu(x: torch.Tensor, fast: bool) -> torch.Tensor:
    return gelu_tanh(x) if fast else gelu_erfc(x)


def layernorm_plain(x, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """(R, C) bf16 -> bf16 LayerNorm with f32 statistics."""
    return layernorm_f32(x.float(), scale, bias, eps).to(_BF16)


def gemm_plain(a, w, bias, epilogue=None, residual=None) -> torch.Tensor:
    """bf16 ``a (M, K) . w (N, K)^T`` rounded to bf16, + bias in bf16, then
    GELU (exact or tanh) or + residual in bf16."""
    y = torch.matmul(a, w.t()) + bias
    if epilogue in ("gelu", "gelu_tanh"):
        return gelu(y, fast=epilogue == "gelu_tanh")
    if epilogue == "residual":
        return residual + y
    return y


def gemm_partial_plain(a, w) -> torch.Tensor:
    """bf16 ``a (M, K) . w (N, K)^T`` in f32 (exact products of the bf16
    values, f32 sums), no bias: a rank's partial products of a row-parallel
    GEMM under tensor parallelism."""
    return torch.matmul(a.float(), w.float().t())


def finish_row_parallel(acc, bias, residual) -> torch.Tensor:
    """The fused residual epilogue on the f32 products summed over the
    ranks: ``bf16(acc) + bias`` in bf16, then ``residual + y`` in bf16, the
    rounding points of :func:`gemm_plain` and of the kernel's epilogue."""
    return residual + (acc.to(_BF16) + bias)


def attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3C) bf16 fused qkv -> (B, N, C) bf16: bf16 logits of
    ``bf16(q * scale) . k``, f32 softmax, f32 ``p . v``."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    t = qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)  # (3,B,H,N,D)
    q = t[0] * bf16_const(D**-0.5)
    s = torch.matmul(q, t[1].transpose(-1, -2))  # bf16 logits
    p = torch.softmax(s.float(), dim=-1)
    o = torch.matmul(p, t[2].float())  # (B, H, N, D) f32
    return o.permute(0, 2, 1, 3).reshape(B, N, C).to(_BF16)


# ----------------------------------------------------- backward twins
# Each is autograd of its forward twin written out: the ops autograd records
# and runs, in the order its engine adds up the gradients that reach one
# tensor (the node created last runs first). Where several terms meet in
# one tensor the order fixes the rounding; a reduction is the same torch
# call autograd makes (``sum_to``), so on the CPU the results are bit for
# bit those of ``torch.autograd.grad`` (tests/test_torch_vit_block_bwd.py).
def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """(R, C) -> (C,): the gradient of a bias broadcast over rows, as
    autograd reduces it (``at::sum_to``)."""
    return t.sum(0, keepdim=True).view(-1)


def layernorm_bwd_plain(x, dy, scale, g_res, eps: float = 1e-6):
    """The backward of :func:`layernorm_plain` beside a residual branch:
    ``x`` (R, C) bf16 the LayerNorm's input, ``dy`` (R, C) bf16 the gradient
    of its output, ``g_res`` (R, C) bf16 the gradient that reaches ``x``
    around it. Returns (``g_res + bf16(dx_ln)`` bf16, dscale, dbias f32)."""
    R, C = x.shape
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    dvar = torch.mean(x32 * x32, dim=-1, keepdim=True) - mu * mu
    r = torch.rsqrt(torch.clamp(dvar, min=0.0) + eps)
    mul = r * scale
    dy32 = dy.float()
    dbias = _sum_rows(dy32)
    g_xc = dy32 * mul
    g_mul = dy32 * (x32 - mu)
    g_mu = (-g_xc).sum(-1, keepdim=True)
    g_r = (g_mul * scale).sum(-1, keepdim=True)
    dscale = _sum_rows(g_mul * r)
    # rsqrt: -0.5 g r^3; clamp(min=0): the gradient where dvar >= 0
    g_dvar = torch.where(dvar >= 0, -0.5 * g_r * r.pow(3), 0.0)
    g_mumu = -g_dvar
    g_mu = (g_mu + g_mumu * mu) + g_mumu * mu
    g_sq = g_dvar.expand(R, C) / C
    dx32 = ((g_xc + g_sq * x32) + g_sq * x32) + g_mu.expand(R, C) / C
    return g_res + dx32.to(_BF16), dscale, dbias


def gelu_bwd_plain(u: torch.Tensor, dh: torch.Tensor, fast: bool):
    """The backward of :func:`gelu` (``fast``: the tanh form) at ``u`` with
    the gradient ``dh``, both bf16. Returns (du, h = gelu(u)), bf16."""
    if fast:
        c = float(torch.tensor((2.0 / np.pi) ** 0.5, dtype=u.dtype))
        k = float(torch.tensor(0.044715, dtype=u.dtype))
        xx = u * u
        x3 = u * xx
        t32 = torch.tanh((c * (u + k * x3)).float())
        cdf = 0.5 * (1.0 + t32.to(u.dtype))
        g_cdf = dh * u
        g_inner = torch.ops.aten.tanh_backward((g_cdf * 0.5).float(), t32)
        g_s = g_inner.to(u.dtype) * c
        g_x3 = g_s * k
        g_xx = g_x3 * u
        du = (((dh * cdf + g_s) + g_x3 * xx) + g_xx * u) + g_xx * u
        return du, u * cdf
    sqrt_half = float(torch.tensor(2.0**-0.5, dtype=u.dtype))
    half_x = u * 0.5
    d32 = ((-u) * sqrt_half).float()
    e = torch.special.erfc(d32).to(u.dtype)
    # erfc: -2/sqrt(pi) exp(-d^2) g
    g_d = ((-2.0 / math.sqrt(math.pi)) * torch.exp(-(d32.pow(2)))
           * (dh * half_x).float()).to(u.dtype)
    return -(g_d * sqrt_half) + (dh * e) * 0.5, half_x * e


def attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """The backward of :func:`attention_plain`: (B, N, 3C) bf16 qkv and the
    (B, N, C) bf16 gradient of its output -> (B, N, 3C) bf16 dqkv. The
    products take the operands ``torch.matmul`` hands ``bmm`` in the
    forward, with their strides."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    BH = B * num_heads
    t = qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    sc = bf16_const(D**-0.5)
    q3 = (t[0] * sc).reshape(BH, N, D)
    kt3 = t[1].transpose(-1, -2).reshape(BH, D, N)
    v3 = t[2].float().reshape(BH, N, D)
    p = torch.softmax(torch.bmm(q3, kt3).view(B, num_heads, N, N).float(),
                      dim=-1)
    p3 = p.view(BH, N, N)
    go3 = do.float().view(B, N, num_heads, D).permute(0, 2, 1, 3).reshape(
        BH, N, D)
    dp = torch.bmm(go3, v3.transpose(1, 2)).view(B, num_heads, N, N)
    dv = torch.bmm(p3.transpose(1, 2), go3).to(_BF16)
    ds = torch._softmax_backward_data(dp, p, -1, torch.float32).to(
        _BF16).view(BH, N, N)
    dq = torch.bmm(ds, kt3.transpose(1, 2)) * sc
    dk = torch.bmm(q3.transpose(1, 2), ds).transpose(1, 2)
    return torch.stack([dq, dk, dv]).view(3, B, num_heads, N, D).permute(
        1, 3, 0, 2, 4).reshape(B, N, C3)


# ------------------------------------------------------- kernel wrappers
# One launch function per kernel: the checks, the launch and its count. It is
# the body of the kernel's torch.library op (KernelOp), which runs it for a
# loaded exported program; eager calls run it directly.
def launch_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    R, C = x.shape
    dev = x.device
    check_layernorm_width(C)
    _check(x, "x", _BF16, (R, C), dev)
    _check(scale, "scale", torch.float32, (C,), dev)
    _check(bias, "bias", torch.float32, (C,), dev)
    out = torch.empty_like(x)
    LIBRARY.launch("vit_layernorm", dev, x.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), R, C, eps)
    launches["layernorm"] += 1
    return out


def launch_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                residual: Optional[torch.Tensor], epilogue: int
                ) -> torch.Tensor:
    M, K = a.shape
    N = w.shape[0]
    dev = a.device
    check_gemm_operands(a, w)
    _check(a, "a", _BF16, (M, K), dev)
    _check(w, "w", _BF16, (N, K), dev)
    _check(bias, "bias", _BF16, (N,), dev)
    if residual is not None:
        _check(residual, "residual", _BF16, (M, N), dev)
    out = torch.empty((M, N), dtype=_BF16, device=dev)
    LIBRARY.launch("vit_gemm", dev, a.data_ptr(), w.data_ptr(),
            bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), M, N, K, epilogue)
    launches["gemm"] += 1
    return out


def launch_gemm_partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    M, K = a.shape
    N = w.shape[0]
    dev = a.device
    check_gemm_operands(a, w)
    _check(a, "a", _BF16, (M, K), dev)
    _check(w, "w", _BF16, (N, K), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    LIBRARY.launch("vit_gemm_f32", dev, a.data_ptr(), w.data_ptr(),
                   out.data_ptr(), M, N, K)
    launches["gemm_f32"] += 1
    return out


def _attention_shape(qkv: torch.Tensor, num_heads: int):
    """(B, N, C, D) of a fused (B, N, 3C) qkv; raises on what the attention
    kernels do not take."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or C % num_heads:
        raise ValueError(f"attention kernel needs 3C columns, got {C3} "
                         f"columns, {num_heads} heads")
    D = C // num_heads
    check_attention_shape(N, D)
    return B, N, C, D


def launch_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C, D = _attention_shape(qkv, num_heads)
    dev = qkv.device
    _check(qkv, "qkv", _BF16, (B, N, 3 * C), dev)
    out = torch.empty((B, N, C), dtype=_BF16, device=dev)
    LIBRARY.launch("vit_attention", dev, qkv.data_ptr(), out.data_ptr(),
            B, N, num_heads, D, bf16_const(D**-0.5))
    launches["attention"] += 1
    return out


LAYERNORM = KernelOp("vit_layernorm", launch_layernorm,
                     lambda x, scale, bias, eps: torch.empty_like(x))
GEMM = KernelOp("vit_gemm", launch_gemm,
                lambda a, w, bias, residual, epilogue: a.new_empty(
                    (a.shape[0], w.shape[0])))
ATTENTION = KernelOp("vit_attention", launch_attention,
                     lambda qkv, num_heads: qkv.new_empty(
                         (*qkv.shape[:2], qkv.shape[2] // 3)))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """(R, C) bf16 -> (R, C) bf16; scale/bias f32 (C,)."""
    if _on_cpu(x):
        return layernorm_plain(x, scale, bias, eps)
    return LAYERNORM(x, scale, bias, eps)


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         epilogue=None, residual=None) -> torch.Tensor:
    """bf16 (M, K) x (N, K)^T -> (M, N) with the bias/GELU/residual
    epilogue; ``epilogue`` is None, ``"gelu"`` (exact), ``"gelu_tanh"`` or
    ``"residual"``."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (residual is not None) != (epilogue == "residual"):
        raise ValueError("residual must be given exactly for "
                         "epilogue='residual'")
    if _on_cpu(a):
        return gemm_plain(a, w, bias, epilogue, residual)
    return GEMM(a, w, bias, residual, _EPILOGUES[epilogue])


def gemm_partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (M, K) x (N, K)^T -> (M, N) f32 products, no epilogue (the
    GEMM kernel's f32 form; see :func:`gemm_partial_plain`)."""
    if _on_cpu(a):
        return gemm_partial_plain(a, w)
    return launch_gemm_partial(a, w)


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3C) bf16 fused qkv -> (B, N, C) bf16 attention output."""
    if _on_cpu(qkv):
        return attention_plain(qkv, num_heads)
    return ATTENTION(qkv, num_heads)


# csrc/vit_block_bwd.cu's LayerNorm backward: rows a block takes at once (a
# warp a row, common.cuh's WARP_ROWS), blocks an SM holds (its launch bounds)
_LN_BWD_ROWS, _LN_BWD_PER_SM = 8, 2


def _ln_bwd_blocks(device: torch.device, rows: int) -> int:
    """Thread blocks of a LayerNorm backward launch: the blocks the card
    holds at once, fewer where there are fewer rows. Each writes one row
    of partial column sums."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-rows // _LN_BWD_ROWS), _LN_BWD_PER_SM * sms)


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                  g_res: torch.Tensor, eps: float = 1e-6):
    """The backward of :func:`layernorm` beside a residual branch: (R, C)
    bf16 ``x``, ``dy``, ``g_res``, f32 (C,) ``scale`` -> (dx bf16, dscale,
    dbias f32); see :func:`layernorm_bwd_plain`. Two launches: the rows
    (with per-block column sums), then the sums of those in block order."""
    if _on_cpu(x):
        return layernorm_bwd_plain(x, dy, scale, g_res, eps)
    R, C = x.shape
    dev = x.device
    check_layernorm_width(C)
    for name, t in (("x", x), ("dy", dy), ("g_res", g_res)):
        _check(t, name, _BF16, (R, C), dev)
    _check(scale, "scale", torch.float32, (C,), dev)
    blocks = _ln_bwd_blocks(dev, R)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, 2, C), dtype=torch.float32, device=dev)
    sums = torch.empty((2, C), dtype=torch.float32, device=dev)
    BWD_LIBRARY.launch("vbb_layernorm_bwd", dev, x.data_ptr(), dy.data_ptr(),
                       scale.data_ptr(), g_res.data_ptr(), dx.data_ptr(),
                       partial.data_ptr(), R, C, blocks, eps)
    bwd_launches["layernorm_bwd"] += 1
    BWD_LIBRARY.launch("vbb_column_sums", dev, partial.data_ptr(),
                       sums.data_ptr(), blocks, 2 * C)
    bwd_launches["layernorm_bwd_sums"] += 1
    return dx, sums[0], sums[1]


def gelu_bwd(u: torch.Tensor, dh: torch.Tensor, fast: bool):
    """The backward of :func:`gelu` at the bf16 pre-activation ``u`` with
    the bf16 gradient ``dh`` (any shape, contiguous): (du, h = gelu(u))."""
    if _on_cpu(u):
        return gelu_bwd_plain(u, dh, fast)
    dev = u.device
    _check(u, "u", _BF16, u.shape, dev)
    _check(dh, "dh", _BF16, u.shape, dev)
    du, h = torch.empty_like(u), torch.empty_like(u)
    BWD_LIBRARY.launch("vbb_gelu_bwd", dev, u.data_ptr(), dh.data_ptr(),
                       du.data_ptr(), h.data_ptr(), u.numel(), int(fast))
    bwd_launches["gelu_bwd"] += 1
    return du, h


def attention_bwd(qkv: torch.Tensor, do: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """The backward of :func:`attention`: (B, N, 3C) bf16 qkv and the (B, N,
    C) bf16 gradient of its output -> (B, N, 3C) bf16 dqkv."""
    if _on_cpu(qkv):
        return attention_bwd_plain(qkv, do, num_heads)
    B, N, C, D = _attention_shape(qkv, num_heads)
    dev = qkv.device
    _check(qkv, "qkv", _BF16, (B, N, 3 * C), dev)
    _check(do, "do", _BF16, (B, N, C), dev)
    dqkv = torch.empty_like(qkv)
    BWD_LIBRARY.launch("vbb_attention_bwd", dev, qkv.data_ptr(),
                       do.data_ptr(), dqkv.data_ptr(), B, N, num_heads, D,
                       bf16_const(D**-0.5))
    bwd_launches["attention_bwd"] += 1
    return dqkv


# ------------------------------------------------------------------ block
class Pieces(NamedTuple):
    """The functions a block and its backward are assembled from."""
    ln: object
    mm: object
    mm_partial: object
    attn: object
    ln_bwd: object
    gelu_bwd: object
    attn_bwd: object


# the kernels' wrappers (their twins for CPU tensors), and the twins
KERNELS = Pieces(layernorm, gemm, gemm_partial, attention, layernorm_bwd,
                 gelu_bwd, attention_bwd)
PLAIN = Pieces(layernorm_plain, gemm_plain, gemm_partial_plain,
               attention_plain, layernorm_bwd_plain, gelu_bwd_plain,
               attention_bwd_plain)


def _residual_mm(f: Pieces, a, w, b, residual, reduce):
    """``residual + (a . w^T + b)``: the fused residual epilogue, or under
    tensor parallelism (``reduce``: the sum of f32 (M, N) products over the
    model ranks) the f32 partial products summed, then the bias and the
    residual added once with the epilogue's roundings."""
    if reduce is None:
        return f.mm(a, w, b, "residual", residual)
    return finish_row_parallel(reduce(f.mm_partial(a, w)), b, residual)


def _block_front(x2, p, B, N, num_heads, f: Pieces, epilogue, reduce=None):
    """The block up to its MLP hidden layer on (B*N, C) rows ``x2``: (y1,
    qkv, o, x1, y2, MLP1 with ``epilogue``). The forward and the backward's
    recompute share it. ``num_heads`` are the heads ``p`` holds (a rank's
    share under tensor parallelism, with ``reduce`` its sum over the ranks;
    see :func:`_residual_mm`)."""
    y1 = f.ln(x2, p["ln1_scale"], p["ln1_bias"])
    qkv = f.mm(y1, p["wqkv"], p["bqkv"])
    o = f.attn(qkv.view(B, N, -1), num_heads).view(B * N, -1)
    x1 = _residual_mm(f, o, p["wproj"], p["bproj"], x2, reduce)
    y2 = f.ln(x1, p["ln2_scale"], p["ln2_bias"])
    return y1, qkv, o, x1, y2, f.mm(y2, p["w1"], p["b1"], epilogue)


def _block(x, p, num_heads, fast_gelu, f: Pieces, reduce=None):
    B, N, C = x.shape
    x2 = x.reshape(B * N, C)
    *_, x1, _, h = _block_front(x2, p, B, N, num_heads, f,
                                "gelu_tanh" if fast_gelu else "gelu", reduce)
    return _residual_mm(f, h, p["w2"], p["b2"], x1, reduce).view(B, N, C)


def vit_block_plain(x: torch.Tensor, params: dict, num_heads: int,
                    fast_gelu: bool = False, reduce=None) -> torch.Tensor:
    """The plain PyTorch twin of the whole block (port of ``block_math``
    with the kernel's rounding points)."""
    return _block(x, params, num_heads, fast_gelu, PLAIN, reduce)


def vit_block_fused(x: torch.Tensor, params: dict, *, num_heads: int,
                    fast_gelu: bool = False, reduce=None) -> torch.Tensor:
    """One ViT block: (B, N, C) bf16 tokens -> (B, N, C) bf16. ``params`` is
    the flat dict of :func:`block_params` (matmul weights bf16 in (out, in)
    layout, biases bf16, LayerNorm scale/bias f32). CUDA tensors run the
    kernels (7 launches), CPU tensors the twin. ``fast_gelu`` takes the
    tanh-approximate GELU in the MLP epilogue.

    Tensor parallelism: ``params`` holds a rank's shard (qkv by heads,
    ``num_heads`` of them; MLP1 by hidden rows; proj and MLP2 by their
    input columns) and ``reduce`` sums an f32 tensor over the model ranks;
    proj and MLP2 then run :func:`gemm_partial`, still 7 launches."""
    return _block(x.to(_BF16), params, num_heads, fast_gelu, KERNELS, reduce)


PARAM_ORDER = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
               "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def _cast_params(params: dict) -> dict:
    """The block's dtype preparation: matmul weights and biases to bf16 (the
    ``nn.Dense`` promotion), LayerNorm scale and bias to f32. A tensor that
    already has its dtype passes through untouched."""
    return {k: v.to(torch.float32 if k.startswith("ln") else _BF16)
            for k, v in params.items()}


def vit_block_backward(x: torch.Tensor, params: dict, g: torch.Tensor,
                       num_heads: int, fast_gelu: bool = False, needs=None,
                       f: Pieces = KERNELS, reduce=None) -> tuple:
    """The gradients of :func:`vit_block_fused_trainable` from its input
    ``x`` and parameters ``params`` as given and the output's gradient
    ``g``: (dx, then one per :data:`PARAM_ORDER`), each in the dtype of what
    it differentiates; None where ``needs`` (13 flags) says no.

    Recomputes the block through ``f`` up to the MLP's pre-GELU activation
    (6 launches with :data:`KERNELS`), then: the gradient products with
    ``torch.matmul`` (the operand order of autograd's ``mm`` backward),
    ``f.gelu_bwd``, ``f.ln_bwd`` twice (each adds the residual's gradient)
    and ``f.attn_bwd`` once. With :data:`PLAIN`, or on CPU tensors, this is
    autograd of :func:`vit_block_plain` op by op.

    Under tensor parallelism (``reduce``, as :func:`vit_block_fused`) the
    recompute runs the sharded forward, and the input gradients of the
    column-parallel products (qkv's, MLP1's), a rank's share, are taken in
    f32 and summed over the ranks before each ``f.ln_bwd``; the parameters'
    gradients are this rank's shards, the LayerNorms' and the row-parallel
    biases' whole (equal on every rank)."""
    names = ("x",) + PARAM_ORDER
    want = dict(zip(names, needs if needs is not None else (True,) * 13))
    p = _cast_params(params)
    B, N, C = x.shape
    x2 = x.to(_BF16).reshape(B * N, C)
    g2 = g.to(_BF16).reshape(B * N, C)
    # The parameters' gradients live until the optimiser has used them: one
    # allocation for the block's (one a dtype), each gradient a view of it
    # that is cast into as soon as it is made, so the caching allocator
    # rounds one block up, not twelve
    slots = {}
    for dtype in dict.fromkeys(params[k].dtype for k in PARAM_ORDER
                               if want[k]):
        group = [k for k in PARAM_ORDER
                 if want[k] and params[k].dtype == dtype]
        sizes = [params[k].numel() for k in group]
        flat = torch.empty(sum(sizes), dtype=dtype, device=x.device)
        for k, t in zip(group, flat.split(sizes)):
            slots[k] = t.view(params[k].shape)
    y1, qkv, o, x1, y2, u = _block_front(x2, p, B, N, num_heads, f, None,
                                         reduce)
    out = {}

    def keep(name, grad):
        """A parameter's gradient, cast into its slot, where it is wanted."""
        if want[name]:
            out[name] = slots[name].copy_(grad)

    def dense(name, dy, a, column=False):
        """The gradients of ``a @ w.T + b`` for the gradient ``dy``; a
        column-parallel product's input gradient summed over the ranks."""
        if want["w" + name]:
            keep("w" + name, dy.t().mm(a))
        if want["b" + name]:
            keep("b" + name, _sum_rows(dy))
        if column and reduce is not None:
            return reduce(dy.float().mm(p["w" + name].float())).to(_BF16)
        return dy.mm(p["w" + name])

    du, h = f.gelu_bwd(u, g2.mm(p["w2"]), fast_gelu)
    del u
    if want["w2"]:
        keep("w2", g2.t().mm(h))
    if want["b2"]:
        keep("b2", _sum_rows(g2))
    del h
    dx1, dscale, dbias = f.ln_bwd(x1, dense("1", du, y2, True),
                                  p["ln2_scale"], g2)
    keep("ln2_scale", dscale)
    keep("ln2_bias", dbias)
    del du, x1, y2
    C3 = qkv.shape[-1]  # 3C, or a rank's 3C / s
    dqkv = f.attn_bwd(qkv.view(B, N, C3),
                      dense("proj", dx1, o).view(B, N, C3 // 3), num_heads)
    del qkv, o
    dx, dscale, dbias = f.ln_bwd(
        x2, dense("qkv", dqkv.view(B * N, C3), y1, True), p["ln1_scale"],
        dx1)
    keep("ln1_scale", dscale)
    keep("ln1_bias", dbias)
    out["x"] = dx.view(x.shape).to(x.dtype)
    return tuple(out.get(k) if want[k] else None for k in names)


class _VitBlockTrainable(torch.autograd.Function):
    """Forward: the kernels (the twin for CPU tensors). Saved for backward:
    the input and the parameters as given, no activation of the block.
    Backward: :func:`vit_block_backward` on the kernels, so f32 master
    parameters receive f32 gradients through the cast."""

    @staticmethod
    def forward(ctx, num_heads, fast_gelu, reduce, x, *flat):
        ctx.num_heads, ctx.fast_gelu, ctx.reduce = num_heads, fast_gelu, reduce
        ctx.save_for_backward(x, *flat)
        return vit_block_fused(x, _cast_params(dict(zip(PARAM_ORDER, flat))),
                               num_heads=num_heads, fast_gelu=fast_gelu,
                               reduce=reduce)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        return (None, None, None) + vit_block_backward(
            x, dict(zip(PARAM_ORDER, flat)), g, ctx.num_heads,
            ctx.fast_gelu, ctx.needs_input_grad[3:], reduce=ctx.reduce)


def vit_block_fused_trainable(x: torch.Tensor, params: dict, num_heads: int,
                              fast_gelu: bool = False,
                              reduce=None) -> torch.Tensor:
    """:func:`vit_block_fused` with a backward: (B, N, C) tokens -> (B, N, C)
    bf16. ``params`` is the flat dict of :func:`block_params` in any float
    dtype (f32 masters are cast per call, as the JAX function casts them).

    Only ``x`` and the parameters are kept between forward and backward, the
    residuals a per-block checkpoint would keep, so do not wrap it in
    ``torch.utils.checkpoint``: a training step costs the kernels' forward,
    then :func:`vit_block_backward` (a recompute and the backward
    kernels). ``reduce``: tensor parallelism, as :func:`vit_block_fused`."""
    return _VitBlockTrainable.apply(num_heads, fast_gelu, reduce, x,
                                    *(params[k] for k in PARAM_ORDER))


def block_params(block) -> dict:
    """Flat operand dict of a port ``Block`` module (models/backbones/vit.py)
    — the counterpart of ``block_params_from_flax`` for the port's own
    parameters."""
    return {
        "ln1_scale": block.norm1.scale, "ln1_bias": block.norm1.bias,
        "wqkv": block.attn.qkv.weight, "bqkv": block.attn.qkv.bias,
        "wproj": block.attn.proj.weight, "bproj": block.attn.proj.bias,
        "ln2_scale": block.norm2.scale, "ln2_bias": block.norm2.bias,
        "w1": block.mlp.fc1.weight, "b1": block.mlp.fc1.bias,
        "w2": block.mlp.fc2.weight, "b2": block.mlp.fc2.bias,
    }


def block_params_from_flax(flax_block: dict, device="cpu",
                           dtype=_BF16) -> dict:
    """A Flax ``Block`` param subtree (numpy leaves, models/backbones/vit.py
    naming) -> the flat dict :func:`vit_block_fused` takes: Dense kernels
    (in, out) transposed to (out, in) and cast to ``dtype`` with their biases
    (bf16 for the bf16 block; float32 for the int8 blocks, which quantise
    from the f32 values), LayerNorm scale/bias kept f32."""
    def dense(d):
        w = torch.from_numpy(np.ascontiguousarray(
            np.asarray(d["kernel"], np.float32).T))
        b = torch.from_numpy(np.array(d["bias"], np.float32))
        return (w.to(device=device, dtype=dtype),
                b.to(device=device, dtype=dtype))

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    wqkv, bqkv = dense(flax_block["attn"]["qkv"])
    wproj, bproj = dense(flax_block["attn"]["proj"])
    w1, b1 = dense(flax_block["mlp"]["Dense_0"])
    w2, b2 = dense(flax_block["mlp"]["Dense_1"])
    return {
        "ln1_scale": f32(flax_block["norm1"]["scale"]),
        "ln1_bias": f32(flax_block["norm1"]["bias"]),
        "wqkv": wqkv, "bqkv": bqkv, "wproj": wproj, "bproj": bproj,
        "ln2_scale": f32(flax_block["norm2"]["scale"]),
        "ln2_bias": f32(flax_block["norm2"]["bias"]),
        "w1": w1, "b1": b1, "w2": w2, "b2": b2,
    }
