"""Knock-out variants of the static W8A8 ViT block: hand-written CUDA kernels
plus their plain PyTorch twins (port of ``scripts/vith_int8_ablation.py``:
``run_variant`` / ``_ablation_kernel`` of the JAX package).

Each of the nine :data:`MODES` is the static block
(:func:`hands_tpu_torch.ops.vit_block_int8.vit_block_fused_int8_static`) with
one piece replaced by its cheapest stand-in of the same shapes and types, so
that ``time(full) - time(mode)`` says what the piece costs:

- ``full``        nothing changed: the static block's seven launches
- ``no_ln``       both LayerNorms -> ``x * s + b`` (no mean, no variance)
- ``no_quant``    every round-and-clip -> the bare cast (after both
  LayerNorms, the attention output, the MLP hidden)
- ``no_gelu``     GELU -> identity
- ``no_softmax``  probabilities -> ``bf16(logits * 0.01)``
- ``no_attn``     attention skipped: ``quant(f32(q third of qkv) * inv_proj)``
- ``attn_i8``     q, k, v quantised with the fixed scale 0.05, both attention
  products int8 with int32 sums, f32 softmax, ``quant(p * 127)``; a timing
  probe, no accuracy claim
- ``attn_merged`` the function of ``full`` through head-major copies: qkv is
  relaid to (3, B*H, N, D), attention runs on contiguous heads and its f32
  output is relaid back and quantised. On the TPU this trades a loop over
  heads for transposes; the port's attention is one grid over (batch row,
  head) anyway, so here the mode measures what the two relayouts cost
- ``mm_only``     the four int8 products chained by bare casts, nothing else:
  the card's int8 floor for the block

The bare cast ``f32 -> int8`` is XLA's: truncation toward zero, saturation at
[-128, 127], NaN -> 0 (:func:`cast_i8`; ``torch.Tensor.to(torch.int8)`` wraps
instead). bf16 rounding points follow the JAX body: ``q * bf16(D^-0.5)`` is a
bf16 product, probabilities are bf16 except in ``attn_i8`` (f32 until
``quant(p * 127)``), the residual adds are bf16.

Each wrapper launches its kernel of ``csrc/vit_block_ablation.cu`` for CUDA
tensors and counts the launch in :data:`launches`; for CPU tensors it runs its
``*_plain`` twin; anything else raises. Pieces a mode leaves alone go through
the static block's own wrappers and are counted there.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops import vit_block_int8 as v8
from hands_tpu_torch.ops.attention import (_strides, qkv_attention,
                                           qkv_attention_plain)
from hands_tpu_torch.ops.cuda_build import (CudaLibrary, check,
                                           check_gemm_operands, on_cpu)
from hands_tpu_torch.ops.vit_block import (ATTN_MAX_D, ATTN_MAX_N, bf16_const,
                                           check_attention_shape,
                                           check_layernorm_width, gelu,
                                           layernorm_f32)

_BF16, _F32, _I8 = torch.bfloat16, torch.float32, torch.int8

MODES = ["full", "no_ln", "no_quant", "no_gelu", "no_softmax", "no_attn",
         "attn_i8", "attn_merged", "mm_only"]

ATTN_I8_SCALE = np.float32(0.05)  # the probe's fixed scale of q, k and v

# kernel launches per wrapper since the last reset (CPU twin runs not counted)
launches: Dict[str, int] = {
    "ln_affine_quant": 0, "ln_cast": 0, "cast_rows": 0, "qslice_quant": 0,
    "heads_split": 0, "heads_merge_quant": 0, "gemm_i8_gelu_cast": 0,
    "gemm_i8_ident_quant": 0, "gemm_i8_cast": 0, "attention_cast": 0,
    "attention_heads": 0, "attention_no_softmax": 0, "attention_i8": 0}

# launches of each mode on the card, by the counter that sees them (the static
# block's wrappers count in ``vit_block_int8.launches`` and
# ``attention.launches``)
MODE_LAUNCHES: Dict[str, Dict[str, int]] = {
    "full": {"ln_quant_static": 2, "gemm_i8_static": 4,
             "qkv_attention_static": 1},
    "no_ln": {"ln_affine_quant": 2, "gemm_i8_static": 4,
              "qkv_attention_static": 1},
    "no_quant": {"ln_cast": 2, "gemm_i8_static": 3, "gemm_i8_gelu_cast": 1,
                 "attention_cast": 1},
    "no_gelu": {"ln_quant_static": 2, "gemm_i8_static": 3,
                "gemm_i8_ident_quant": 1, "qkv_attention_static": 1},
    "no_softmax": {"ln_quant_static": 2, "gemm_i8_static": 4,
                   "attention_no_softmax": 1},
    "no_attn": {"ln_quant_static": 2, "gemm_i8_static": 4, "qslice_quant": 1},
    "attn_i8": {"ln_quant_static": 2, "gemm_i8_static": 4, "attention_i8": 1},
    "attn_merged": {"ln_quant_static": 2, "gemm_i8_static": 4,
                    "heads_split": 1, "attention_heads": 1,
                    "heads_merge_quant": 1},
    "mm_only": {"cast_rows": 1, "gemm_i8_cast": 3, "gemm_i8_static": 1},
}

_EPI = {"gelu_cast": 0, "ident_quant": 1, "cast": 2}
_ATTN = {"cast": 3, "heads": 4, "no_softmax": 5}  # modes of the kernel


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.abl_ln.argtypes = [i, p, p, p, p, i, i, f, i, i, p]
    lib.abl_cast_rows.argtypes = [i, p, p, ll, i, p]
    lib.abl_qslice_quant.argtypes = [i, p, p, p, ll, i, ll, i, p]
    lib.abl_heads_split.argtypes = [i, p, p, i, i, i, i, i, p]
    lib.abl_heads_merge_quant.argtypes = [i, p, p, p, i, i, i, i, i, p]
    lib.abl_gemm.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.abl_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, ll, ll, f, i,
                                  p]
    lib.abl_attention_i8.argtypes = [i, p, p, p, p, p, i, i, i, i, ll, ll, f,
                                     f, f, f, p]
    for fn in (lib.abl_ln, lib.abl_cast_rows, lib.abl_qslice_quant,
               lib.abl_heads_split, lib.abl_heads_merge_quant, lib.abl_gemm,
               lib.abl_attention, lib.abl_attention_i8):
        fn.restype = ctypes.c_int


# -fmad=false: as the static block's library, f32 chains round op by op
LIBRARY = CudaLibrary("vit_block_ablation", _bind, "abl_error_string",
                      extra_flags=("-fmad=false",))


def attn_i8_multipliers(head_dim: int):
    """(q, k and v, logit, output) f32 multipliers of ``attn_i8``, each
    computed in f32 as the JAX body does: ``D^-0.5 / qs``, ``1 / qs``,
    ``qs * qs``, ``qs / 127``."""
    qs = ATTN_I8_SCALE
    return (float(np.float32(head_dim**-0.5) / qs),
            float(np.float32(1.0) / qs), float(qs * qs),
            float(qs / np.float32(127.0)))


# ------------------------------------------------------------- plain twins
def cast_i8(a32: torch.Tensor) -> torch.Tensor:
    """The bare ``astype(int8)`` of an f32 tensor as XLA compiles it:
    truncation toward zero, saturation at [-128, 127], NaN -> 0."""
    a = torch.nan_to_num(a32.float(), nan=0.0)
    return torch.trunc(torch.clamp(a, -128.0, 127.0)).to(_I8)


def ln_ablation_plain(x, scale, bias, no_ln: bool, cast: bool,
                      eps: float = 1e-6) -> torch.Tensor:
    """(R, C) bf16 -> int8: LayerNorm (or ``x * s + b`` with ``no_ln``) in
    f32, then round-and-clip (or the bare cast with ``cast``)."""
    x32 = x.float()
    y = x32 * scale + bias if no_ln else layernorm_f32(x32, scale, bias, eps)
    return cast_i8(y) if cast else quant.quant_static(y)


def cast_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return cast_i8(x.float())


def qslice_quant_plain(qkv: torch.Tensor, inv_out: torch.Tensor
                       ) -> torch.Tensor:
    """(B, N, 3C) bf16 -> (B, N, C) int8: the q third times ``inv_out``,
    rounded and clipped."""
    C = qkv.shape[-1] // 3
    return quant.quant_static(qkv[..., :C].float() * inv_out)


def gemm_i8_ablation_plain(a_q, w_q, col_scale, bias, epilogue: str,
                           inv_next=None, fast_gelu: bool = False,
                           keep_cols=None) -> torch.Tensor:
    """int8 ``a_q (M, K) . w_q (N, K)^T`` in int32, ``acc * d + b`` in f32
    as one fused multiply-add, then ``cast(gelu(.) * inv_next)`` |
    ``quant(. * inv_next)`` | ``cast(.)`` of the first ``keep_cols``
    columns."""
    v = quant.dequant_static(quant.int_matmul(a_q, w_q), col_scale, bias)
    if epilogue == "gelu_cast":
        return cast_i8(gelu(v, fast_gelu) * inv_next)
    if epilogue == "ident_quant":
        return quant.quant_static(v * inv_next)
    return cast_i8(v[:, :keep_cols]).contiguous()


def _heads(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    return qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)


def attention_ablation_plain(qkv, num_heads: int, inv_out, variant: str
                             ) -> torch.Tensor:
    """(B, N, 3C) bf16 -> (B, N, C) int8. ``cast``: the static attention with
    the bare cast as its store; ``no_softmax``: probabilities
    ``bf16(logits * 0.01)``."""
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    t = _heads(qkv, num_heads)  # (3, B, H, N, D)
    q = t[0] * bf16_const(D**-0.5)
    s = torch.matmul(q.float(), t[1].float().transpose(-1, -2))
    if variant == "no_softmax":
        p = (s * 0.01).to(_BF16).float()
    else:
        p = torch.softmax(s, dim=-1).to(_BF16).float()
    o = torch.matmul(p, t[2].float()).permute(0, 2, 1, 3).reshape(B, N, -1)
    o = o * inv_out
    return cast_i8(o) if variant == "cast" else quant.quant_static(o)


def attention_i8_plain(qkv, num_heads: int, inv_out) -> torch.Tensor:
    """(B, N, 3C) bf16 -> (B, N, C) int8 with both products in int8."""
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    q_mul, kv_mul, s_mul, o_mul = attn_i8_multipliers(D)
    t = _heads(qkv, num_heads).float()
    # integer values up to 127^2 * D and 127^2 * N: exact in f64
    qq = quant.quant_static(t[0] * q_mul).double()
    kq = quant.quant_static(t[1] * kv_mul).double()
    vq = quant.quant_static(t[2] * kv_mul).double()
    s = torch.matmul(qq, kq.transpose(-1, -2)).float() * s_mul
    pq = quant.quant_static(torch.softmax(s, dim=-1) * 127.0).double()
    o = torch.matmul(pq, vq).float() * o_mul
    o = o.permute(0, 2, 1, 3).reshape(B, N, -1)
    return quant.quant_static(o * inv_out)


def heads_split_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3C) -> head-major (3, B*H, N, D)."""
    B, N, C3 = qkv.shape
    D = C3 // 3 // num_heads
    return _heads(qkv, num_heads).reshape(3, B * num_heads, N, D)


def attention_heads_plain(qkvh: torch.Tensor) -> torch.Tensor:
    """Head-major (3, G, N, D) bf16 -> f32 (G, N, D): the static attention's
    arithmetic up to its f32 output."""
    D = qkvh.shape[-1]
    q = qkvh[0] * bf16_const(D**-0.5)
    s = torch.matmul(q.float(), qkvh[1].float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(_BF16).float()
    return torch.matmul(p, qkvh[2].float())


def heads_merge_quant_plain(o: torch.Tensor, inv_out: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """f32 (B*H, N, D) -> int8 (B, N, C): relaid, times ``inv_out``, rounded
    and clipped."""
    G, N, D = o.shape
    B = G // num_heads
    o = o.view(B, num_heads, N, D).permute(0, 2, 1, 3).reshape(B, N, -1)
    return quant.quant_static(o * inv_out)


# ------------------------------------------------------- kernel wrappers
def ln_ablation(x, scale, bias, no_ln: bool, cast: bool, eps: float = 1e-6
                ) -> torch.Tensor:
    """See :func:`ln_ablation_plain`; exactly one of ``no_ln``
    (``ln_affine_quant``) and ``cast`` (``ln_cast``) is set: without a
    knock-out it is the static block's ``ln_quant``. The kernel takes
    ``ln_quant``'s widths: a multiple of 8 up to 2048."""
    if no_ln == cast:
        raise ValueError("ln_ablation takes one knock-out, no_ln or cast "
                         "(without one it is ln_quant)")
    if on_cpu(x):
        return ln_ablation_plain(x, scale, bias, no_ln, cast, eps)
    R, C = x.shape
    dev = x.device
    check_layernorm_width(C)
    check(x, "x", _BF16, (R, C), dev)
    check(scale, "scale", _F32, (C,), dev)
    check(bias, "bias", _F32, (C,), dev)
    q = torch.empty((R, C), dtype=_I8, device=dev)
    LIBRARY.launch("abl_ln", dev, x.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), q.data_ptr(), R, C, eps, int(no_ln),
                   int(cast))
    launches["ln_cast" if cast else "ln_affine_quant"] += 1
    return q


def _narrowing_bytes(widths, bf16_ptrs, i8_ptrs, f32_ptrs=()) -> int:
    """The widest load of a bf16 -> int8 pass: 16 bytes (8 values), 4 (2)
    or 2 (1), the first that every width (in values) divides into and every
    pointer allows: bf16 inputs at the load's width, int8 outputs at half of
    it, f32 operands at twice it up to 16 bytes."""
    for vec in (16, 4):
        w = vec // 2
        if (all(n % w == 0 for n in widths)
                and all(ptr % vec == 0 for ptr in bf16_ptrs)
                and all(ptr % w == 0 for ptr in i8_ptrs)
                and all(ptr % min(4 * w, 16) == 0 for ptr in f32_ptrs)):
            return vec
    return 2


def cast_vector_bytes(x_ptr: int, q_ptr: int) -> int:
    """The width of :func:`cast_rows`' loads: 16 bytes of 8 bf16 values
    (their 8 int8 results one 8-byte store) from a 16-byte aligned ``x``
    into an 8-byte aligned ``q``, else 4 bytes of 2 values, else 1 value
    (the kernel's narrow forms); any count of values, the last ``n % 8``
    (or ``n % 2``) a tail."""
    return _narrowing_bytes((), (x_ptr,), (q_ptr,))


def qslice_vector_bytes(C: int, row_stride: int, qkv_ptr: int, inv_ptr: int,
                        out_ptr: int) -> int:
    """The width of :func:`qslice_quant`'s loads: 16 bytes of 8 bf16 values
    (inv's 8 values two float4, the 8 int8 results one 8-byte store) where
    ``C`` and the row stride of ``qkv`` are multiples of 8 and the pointers
    allow it, else 4 bytes of 2 values (both even), else 1 value."""
    return _narrowing_bytes((C, row_stride), (qkv_ptr,), (out_ptr,),
                            (inv_ptr,))


def cast_rows(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> int8 by the bare cast, elementwise; ``x`` is contiguous bf16
    (at any address: :func:`cast_vector_bytes` picks the kernel's form)."""
    if on_cpu(x):
        return cast_rows_plain(x)
    if x.dtype != _BF16 or not x.is_contiguous():
        raise ValueError(f"x: want contiguous bf16, got {x.dtype} "
                         f"(contiguous={x.is_contiguous()})")
    q = torch.empty(x.shape, dtype=_I8, device=x.device)
    LIBRARY.launch("abl_cast_rows", x.device, x.data_ptr(), q.data_ptr(),
                   x.numel(), cast_vector_bytes(x.data_ptr(), q.data_ptr()))
    launches["cast_rows"] += 1
    return q


def qslice_quant(qkv: torch.Tensor, inv_out: torch.Tensor) -> torch.Tensor:
    """See :func:`qslice_quant_plain`; any width, the first ``C3 // 3``
    columns of each (B, N, C3) row (:func:`qslice_vector_bytes` picks the
    kernel's form)."""
    if on_cpu(qkv):
        return qslice_quant_plain(qkv, inv_out)
    B, N, C3 = qkv.shape
    C = C3 // 3
    dev = qkv.device
    check(qkv, "qkv", _BF16, (B, N, C3), dev)
    check(inv_out, "inv_out", _F32, (C,), dev)
    out = torch.empty((B, N, C), dtype=_I8, device=dev)
    LIBRARY.launch("abl_qslice_quant", dev, qkv.data_ptr(),
                   inv_out.data_ptr(), out.data_ptr(), B * N, C, C3,
                   qslice_vector_bytes(C, C3, qkv.data_ptr(),
                                       inv_out.data_ptr(), out.data_ptr()))
    launches["qslice_quant"] += 1
    return out


def gemm_i8_ablation(a_q, w_q, col_scale, bias, epilogue: str, inv_next=None,
                     fast_gelu: bool = False, keep_cols=None) -> torch.Tensor:
    """int8 (M, K) x (N, K)^T -> int8 with a knocked-out epilogue; see
    :func:`gemm_i8_ablation_plain`. ``epilogue`` is ``"gelu_cast"``,
    ``"ident_quant"`` (both need ``inv_next``) or ``"cast"`` (keeps the first
    ``keep_cols`` columns, all by default)."""
    if epilogue not in _EPI:
        raise ValueError(f"no knocked-out int8 GEMM epilogue {epilogue!r}")
    if (inv_next is not None) != (epilogue != "cast"):
        raise ValueError("inv_next must be given exactly for the epilogues "
                         "that quantise for a next product")
    M, K = a_q.shape
    N = w_q.shape[0]
    keep = N if keep_cols is None else int(keep_cols)
    if epilogue != "cast" and keep != N or not 0 < keep <= N:
        raise ValueError(f"keep_cols={keep_cols} with epilogue {epilogue!r}")
    if on_cpu(a_q):
        return gemm_i8_ablation_plain(a_q, w_q, col_scale, bias, epilogue,
                                      inv_next, fast_gelu, keep)
    dev = a_q.device
    check_gemm_operands(a_q, w_q)
    check(a_q, "a_q", _I8, (M, K), dev)
    check(w_q, "w_q", _I8, (N, K), dev)
    check(col_scale, "col_scale", _F32, (N,), dev)
    check(bias, "bias", _F32, (N,), dev)
    if inv_next is not None:
        check(inv_next, "inv_next", _F32, (N,), dev)
    out = torch.empty((M, keep), dtype=_I8, device=dev)
    LIBRARY.launch("abl_gemm", dev, a_q.data_ptr(), w_q.data_ptr(),
                   col_scale.data_ptr(), bias.data_ptr(),
                   None if inv_next is None else inv_next.data_ptr(),
                   out.data_ptr(), M, N, K, _EPI[epilogue], int(fast_gelu),
                   keep)
    launches[f"gemm_i8_{epilogue}"] += 1
    return out


def _qkv_views(qkv: torch.Tensor, num_heads: int):
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3 or C % num_heads:
        raise ValueError(f"attention kernel needs 3C columns, got {C3} "
                         f"columns, {num_heads} heads")
    D = C // num_heads
    check(qkv, "qkv", _BF16, (B, N, C3), qkv.device)
    t = qkv.view(B, N, 3, num_heads, D)
    q = t[:, :, 0]
    if D % 2:
        raise ValueError("bf16 attention needs an even head dim")
    return (q, t[:, :, 1], t[:, :, 2]), _strides(q, B, N, num_heads, D), D


def attention_ablation(qkv, num_heads: int, inv_out, variant: str
                       ) -> torch.Tensor:
    """See :func:`attention_ablation_plain`; ``variant`` is ``"cast"`` or
    ``"no_softmax"``."""
    if variant not in ("cast", "no_softmax"):
        raise ValueError(f"no attention knock-out {variant!r}")
    if on_cpu(qkv):
        return attention_ablation_plain(qkv, num_heads, inv_out, variant)
    B, N, C3 = qkv.shape
    (q, k, v), (sb, sn), D = _qkv_views(qkv, num_heads)
    check_attention_shape(N, D)
    dev = qkv.device
    check(inv_out, "inv_out", _F32, (C3 // 3,), dev)
    out = torch.empty((B, N, C3 // 3), dtype=_I8, device=dev)
    LIBRARY.launch("abl_attention", dev, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), inv_out.data_ptr(), B, N,
                   num_heads, D, sb, sn, bf16_const(D**-0.5), _ATTN[variant])
    launches[f"attention_{variant}"] += 1
    return out


def check_attention_i8_shape(N: int, D: int) -> None:
    """Raise unless the int8 attention kernel takes ``N`` tokens with head
    dim ``D``: D a multiple of 4 up to :data:`ATTN_MAX_D`, N up to
    :data:`ATTN_MAX_N` (a row of logits in registers)."""
    if D % 4 or not 4 <= D <= ATTN_MAX_D:
        raise ValueError(f"int8 attention kernel needs a head dim that is a "
                         f"multiple of 4 up to {ATTN_MAX_D}, got {D}")
    if not 1 <= N <= ATTN_MAX_N:
        raise ValueError(f"int8 attention kernel takes 1 to {ATTN_MAX_N} "
                         f"tokens (a row of logits in registers), got {N}")


def attention_i8(qkv, num_heads: int, inv_out) -> torch.Tensor:
    """See :func:`attention_i8_plain`."""
    if on_cpu(qkv):
        return attention_i8_plain(qkv, num_heads, inv_out)
    B, N, C3 = qkv.shape
    (q, k, v), (sb, sn), D = _qkv_views(qkv, num_heads)
    check_attention_i8_shape(N, D)
    dev = qkv.device
    check(inv_out, "inv_out", _F32, (C3 // 3,), dev)
    out = torch.empty((B, N, C3 // 3), dtype=_I8, device=dev)
    LIBRARY.launch("abl_attention_i8", dev, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), inv_out.data_ptr(), B, N,
                   num_heads, D, sb, sn, *attn_i8_multipliers(D))
    launches["attention_i8"] += 1
    return out


def _vector_bytes(segment_bytes: int, ptrs) -> int:
    wide = segment_bytes % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return 16 if wide else 4


def split_vector_bytes(head_dim: int, *ptrs: int) -> int:
    """The width of :func:`heads_split`'s copy: 16-byte vectors when a head
    segment is a whole number of them (``head_dim % 8 == 0``) and every
    pointer is 16-byte aligned, else 4 bytes (the kernel's narrow form)."""
    return _vector_bytes(2 * head_dim, ptrs)


def merge_vector_bytes(head_dim: int, *ptrs: int) -> int:
    """The width of :func:`heads_merge_quant`'s reads: 16-byte vectors of 4
    f32 values (their 4 int8 results one 4-byte store) when a head segment
    is a whole number of them (``head_dim % 4 == 0``) and every pointer is
    16-byte aligned, else 4 bytes, one value (the kernel's narrow form)."""
    return _vector_bytes(4 * head_dim, ptrs)


def heads_split(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """See :func:`heads_split_plain`; the copy is a kernel of this module.
    ``qkv`` is contiguous bf16 starting at a 4-byte boundary, its head dim
    even."""
    if on_cpu(qkv):
        return heads_split_plain(qkv, num_heads).contiguous()
    B, N, C3 = qkv.shape
    if C3 % 3 or C3 // 3 % num_heads:
        raise ValueError(f"heads_split needs 3C columns, got {C3} columns, "
                         f"{num_heads} heads")
    D = C3 // 3 // num_heads
    if D % 2:
        raise ValueError(f"heads_split kernel needs an even head dim (4-byte "
                         f"vectors), got {D}")
    if (qkv.dtype != _BF16 or not qkv.is_contiguous()
            or qkv.data_ptr() % 4):
        raise ValueError(f"qkv: want contiguous bf16 at a 4-byte boundary, "
                         f"got {qkv.dtype} at {qkv.data_ptr():#x} "
                         f"(contiguous={qkv.is_contiguous()})")
    out = torch.empty((3, B * num_heads, N, D), dtype=_BF16,
                      device=qkv.device)
    LIBRARY.launch("abl_heads_split", qkv.device, qkv.data_ptr(),
                   out.data_ptr(), B, N, num_heads, D,
                   split_vector_bytes(D, qkv.data_ptr(), out.data_ptr()))
    launches["heads_split"] += 1
    return out


def attention_heads(qkvh: torch.Tensor) -> torch.Tensor:
    """See :func:`attention_heads_plain`."""
    if on_cpu(qkvh):
        return attention_heads_plain(qkvh)
    _, G, N, D = qkvh.shape
    dev = qkvh.device
    check_attention_shape(N, D)
    check(qkvh, "qkvh", _BF16, (3, G, N, D), dev)
    out = torch.empty((G, N, D), dtype=_F32, device=dev)
    # every head a batch row of one head: batch stride N*D, row stride D
    LIBRARY.launch("abl_attention", dev, qkvh[0].data_ptr(),
                   qkvh[1].data_ptr(), qkvh[2].data_ptr(), out.data_ptr(),
                   None, G, N, 1, D, N * D, D, bf16_const(D**-0.5),
                   _ATTN["heads"])
    launches["attention_heads"] += 1
    return out


def heads_merge_quant(o: torch.Tensor, inv_out: torch.Tensor, num_heads: int
                      ) -> torch.Tensor:
    """See :func:`heads_merge_quant_plain`; the relayout is a kernel of this
    module. ``o`` is contiguous f32 (any 4-byte boundary)."""
    if on_cpu(o):
        return heads_merge_quant_plain(o, inv_out, num_heads)
    G, N, D = o.shape
    if G % num_heads:
        raise ValueError(f"{G} head rows do not divide into {num_heads} heads")
    B, dev = G // num_heads, o.device
    if o.dtype != _F32 or not o.is_contiguous():
        raise ValueError(f"o: want contiguous f32, got {o.dtype} "
                         f"(contiguous={o.is_contiguous()})")
    check(inv_out, "inv_out", _F32, (num_heads * D,), dev)
    out = torch.empty((B, N, num_heads * D), dtype=_I8, device=dev)
    LIBRARY.launch("abl_heads_merge_quant", dev, o.data_ptr(),
                   inv_out.data_ptr(), out.data_ptr(), B, N, num_heads, D,
                   merge_vector_bytes(D, o.data_ptr(), inv_out.data_ptr(),
                                      out.data_ptr()))
    launches["heads_merge_quant"] += 1
    return out


# ------------------------------------------------------------------ blocks
class _Pieces:
    """The functions a block is assembled from: the kernels' wrappers or
    their plain twins."""

    def __init__(self, plain: bool):
        if plain:
            self.lnq = lambda x, s, b: v8.ln_quant_plain(x, s, b, False)[0]
            self.ln_abl, self.mm = ln_ablation_plain, v8.gemm_i8_plain
            self.mm_abl, self.attn = (gemm_i8_ablation_plain,
                                      qkv_attention_plain)
            self.attn_abl, self.attn_i8 = (attention_ablation_plain,
                                           attention_i8_plain)
            self.cast, self.qslice = cast_rows_plain, qslice_quant_plain
            self.split, self.attn_heads, self.merge = (
                heads_split_plain, attention_heads_plain,
                heads_merge_quant_plain)
        else:
            self.lnq = lambda x, s, b: v8.ln_quant(x, s, b, False)[0]
            self.ln_abl, self.mm = ln_ablation, v8.gemm_i8
            self.mm_abl, self.attn = gemm_i8_ablation, qkv_attention
            self.attn_abl, self.attn_i8 = attention_ablation, attention_i8
            self.cast, self.qslice = cast_rows, qslice_quant
            self.split, self.attn_heads, self.merge = (
                heads_split, attention_heads, heads_merge_quant)


def _block(x, op, num_heads: int, mode: str, fast_gelu: bool, f: _Pieces):
    if mode not in MODES:
        raise ValueError(f"no ablation mode {mode!r}; one of {MODES}")
    B, N, C = x.shape
    R = B * N
    x2 = x.reshape(R, C)
    if mode == "mm_only":
        a = f.mm_abl(f.cast(x2), op["wqkv_q"], op["dqkv"], op["bqkv"], "cast",
                     keep_cols=C)
        b = f.mm_abl(a, op["wproj_q"], op["dproj"], op["bproj"], "cast")
        c = f.mm_abl(b, op["w1_q"], op["d1"], op["b1"], "cast")
        return f.mm(c, op["w2_q"], op["d2"], op["b2"]).view(B, N, C)

    def ln(t, s, b):
        if mode == "no_ln":
            return f.ln_abl(t, s, b, True, False)
        if mode == "no_quant":
            return f.ln_abl(t, s, b, False, True)
        return f.lnq(t, s, b)

    qkv = f.mm(ln(x2, op["ln1_s"], op["ln1_b"]), op["wqkv_q"], op["dqkv"],
               op["bqkv"]).view(B, N, 3 * C)
    inv = op["inv_proj"]
    if mode == "no_attn":
        qo = f.qslice(qkv, inv)
    elif mode == "attn_merged":
        qo = f.merge(f.attn_heads(f.split(qkv, num_heads)), inv, num_heads)
    elif mode == "attn_i8":
        qo = f.attn_i8(qkv, num_heads, inv)
    elif mode == "no_softmax":
        qo = f.attn_abl(qkv, num_heads, inv, "no_softmax")
    elif mode == "no_quant":
        qo = f.attn_abl(qkv, num_heads, inv, "cast")
    else:
        qo = f.attn(qkv, num_heads, inv)
    x1 = f.mm(qo.view(R, C), op["wproj_q"], op["dproj"], op["bproj"],
              epilogue="residual", residual=x2)
    qy2 = ln(x1, op["ln2_s"], op["ln2_b"])
    if mode == "no_quant":
        qh = f.mm_abl(qy2, op["w1_q"], op["d1"], op["b1"], "gelu_cast",
                      op["inv_mlp2"], fast_gelu)
    elif mode == "no_gelu":
        qh = f.mm_abl(qy2, op["w1_q"], op["d1"], op["b1"], "ident_quant",
                      op["inv_mlp2"])
    else:
        qh = f.mm(qy2, op["w1_q"], op["d1"], op["b1"], epilogue="gelu",
                  inv_next=op["inv_mlp2"], fast_gelu=fast_gelu)
    out = f.mm(qh, op["w2_q"], op["d2"], op["b2"], epilogue="residual",
               residual=x1)
    return out.view(B, N, C)


_PLAIN, _KERNELS = _Pieces(True), _Pieces(False)


def vit_block_ablation_plain(x: torch.Tensor, op: dict, num_heads: int,
                             mode: str, fast_gelu: bool = True
                             ) -> torch.Tensor:
    """The plain PyTorch twin of every mode (the arithmetic of
    ``_ablation_kernel``, op for op)."""
    return _block(x.to(_BF16), op, num_heads, mode, fast_gelu, _PLAIN)


def vit_block_ablation(x: torch.Tensor, op: dict, *, num_heads: int,
                       mode: str, fast_gelu: bool = True) -> torch.Tensor:
    """The static W8A8 block with ``mode``'s piece knocked out: (B, N, C)
    bf16 -> (B, N, C) bf16. ``op`` is the dict of
    ``quant.fold_static_scales``. CUDA tensors run the kernels
    (:data:`MODE_LAUNCHES`), CPU tensors the twin."""
    return _block(x.to(_BF16), op, num_heads, mode, fast_gelu, _KERNELS)
