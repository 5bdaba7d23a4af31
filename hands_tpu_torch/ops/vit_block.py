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
tensor on any other device, or one the kernel does not take, raises.

:func:`vit_block_fused_trainable` (port of the JAX function of that name) is
the block for training: the same seven launches forward, and a backward that
keeps only the block's input and parameters and differentiates the twin.

The shared library is built with ``nvcc`` at first use
(:mod:`hands_tpu_torch.ops.cuda_build`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from hands_tpu_torch.ops.cuda_build import CudaLibrary
from hands_tpu_torch.ops.cuda_build import check as _check
from hands_tpu_torch.ops.cuda_build import check_gemm_operands
from hands_tpu_torch.ops.cuda_build import on_cpu as _on_cpu

_EPILOGUES = {None: 0, "gelu": 1, "residual": 2, "gelu_tanh": 3}
_BF16 = torch.bfloat16

# kernel launches per wrapper since the last reset (CPU twin runs not counted)
launches: Dict[str, int] = {"layernorm": 0, "gemm": 0, "attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vit_layernorm.argtypes = [i, p, p, p, p, i, i, f, p]
    lib.vit_gemm.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    lib.vit_attention.argtypes = [i, p, p, i, i, i, i, f, p]
    for fn in (lib.vit_layernorm, lib.vit_gemm, lib.vit_attention):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("vit_block", _bind, "vit_error_string")


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


# ------------------------------------------------------- kernel wrappers
def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """(R, C) bf16 -> (R, C) bf16; scale/bias f32 (C,)."""
    if _on_cpu(x):
        return layernorm_plain(x, scale, bias, eps)
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
            out.data_ptr(), M, N, K, _EPILOGUES[epilogue])
    launches["gemm"] += 1
    return out


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3C) bf16 fused qkv -> (B, N, C) bf16 attention output."""
    if _on_cpu(qkv):
        return attention_plain(qkv, num_heads)
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    dev = qkv.device
    if C3 % 3 or C % num_heads:
        raise ValueError(f"attention kernel needs 3C columns, got {C3} "
                         f"columns, {num_heads} heads")
    check_attention_shape(N, D)
    _check(qkv, "qkv", _BF16, (B, N, C3), dev)
    out = torch.empty((B, N, C), dtype=_BF16, device=dev)
    LIBRARY.launch("vit_attention", dev, qkv.data_ptr(), out.data_ptr(),
            B, N, num_heads, D, bf16_const(D**-0.5))
    launches["attention"] += 1
    return out


# ------------------------------------------------------------------ block
def _block(x, p, num_heads, fast_gelu, ln, mm, attn):
    B, N, C = x.shape
    x2 = x.reshape(B * N, C)
    y = ln(x2, p["ln1_scale"], p["ln1_bias"])
    qkv = mm(y, p["wqkv"], p["bqkv"])
    o = attn(qkv.view(B, N, 3 * C), num_heads).view(B * N, C)
    x1 = mm(o, p["wproj"], p["bproj"], "residual", x2)
    y2 = ln(x1, p["ln2_scale"], p["ln2_bias"])
    h = mm(y2, p["w1"], p["b1"], "gelu_tanh" if fast_gelu else "gelu")
    return mm(h, p["w2"], p["b2"], "residual", x1).view(B, N, C)


def vit_block_plain(x: torch.Tensor, params: dict, num_heads: int,
                    fast_gelu: bool = False) -> torch.Tensor:
    """The plain PyTorch twin of the whole block (port of ``block_math``
    with the kernel's rounding points)."""
    return _block(x, params, num_heads, fast_gelu, layernorm_plain,
                  gemm_plain, attention_plain)


def vit_block_fused(x: torch.Tensor, params: dict, *, num_heads: int,
                    fast_gelu: bool = False) -> torch.Tensor:
    """One ViT block: (B, N, C) bf16 tokens -> (B, N, C) bf16. ``params`` is
    the flat dict of :func:`block_params` (matmul weights bf16 in (out, in)
    layout, biases bf16, LayerNorm scale/bias f32). CUDA tensors run the
    kernels (7 launches), CPU tensors the twin. ``fast_gelu`` takes the
    tanh-approximate GELU in the MLP epilogue."""
    return _block(x.to(_BF16), params, num_heads, fast_gelu, layernorm, gemm,
                  attention)


PARAM_ORDER = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
               "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def _cast_params(params: dict) -> dict:
    """The block's dtype preparation: matmul weights and biases to bf16 (the
    ``nn.Dense`` promotion), LayerNorm scale and bias to f32. A tensor that
    already has its dtype passes through untouched."""
    return {k: v.to(torch.float32 if k.startswith("ln") else _BF16)
            for k, v in params.items()}


class _VitBlockTrainable(torch.autograd.Function):
    """Forward: the kernels (the twin for CPU tensors). Saved for backward:
    the input and the parameters as given, no activation of the block.
    Backward: recompute the block through :func:`vit_block_plain`, dtype
    preparation included, and take autograd's gradients of it, so f32 master
    parameters receive f32 gradients through the cast."""

    @staticmethod
    def forward(ctx, num_heads, fast_gelu, x, *flat):
        ctx.num_heads, ctx.fast_gelu = num_heads, fast_gelu
        ctx.save_for_backward(x, *flat)
        return vit_block_fused(x, _cast_params(dict(zip(PARAM_ORDER, flat))),
                               num_heads=num_heads, fast_gelu=fast_gelu)

    @staticmethod
    def backward(ctx, g):
        # no backward kernel (the TPU kernel has none): differentiate the twin
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = vit_block_plain(
                ins[0].to(_BF16), _cast_params(dict(zip(PARAM_ORDER, ins[1:]))),
                ctx.num_heads, ctx.fast_gelu)
            got = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, needs) if n], g.to(_BF16)))
        return (None, None) + tuple(next(got) if n else None for n in needs)


def vit_block_fused_trainable(x: torch.Tensor, params: dict, num_heads: int,
                              fast_gelu: bool = False) -> torch.Tensor:
    """:func:`vit_block_fused` with a backward: (B, N, C) tokens -> (B, N, C)
    bf16. ``params`` is the flat dict of :func:`block_params` in any float
    dtype (f32 masters are cast per call, as the JAX function casts them).

    Only ``x`` and the parameters are kept between forward and backward, the
    residuals a per-block checkpoint would keep, so do not wrap it in
    ``torch.utils.checkpoint``: a training step costs the kernels' forward,
    then the twin's forward and backward."""
    return _VitBlockTrainable.apply(num_heads, fast_gelu, x,
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
