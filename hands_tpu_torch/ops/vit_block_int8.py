"""W8A8 ViT blocks: hand-written CUDA kernels plus their plain PyTorch twins
(port of ``vit_block_fused_int8`` and ``vit_block_fused_int8_static`` of
``hands_tpu/ops/vit_block_pallas.py``).

Both blocks run the four dense products int8 x int8 -> int32 with
per-output-channel weight scales. The *dynamic* block quantises activations
per token on the fly (row max-abs), keeps an f32 residual stream and f32
attention probabilities. The *static* block takes calibrated per-channel
activation scales already folded into its operands
(:func:`hands_tpu_torch.ops.quant.fold_static_scales`), so quantising is a
bare round/clip/cast; its residual stream and probabilities are bf16 and its
attention output is written as int8. Both are lossy serving modes.

Operands are prepared once (``quant.prepare_int8`` / ``fold_static_scales``)
from the f32 weights, not per call: the int8 weights of a bf16-rounded copy
would differ from the JAX package's.

Each wrapper (:func:`ln_quant`, :func:`quant_rows`, :func:`gemm_i8`) launches
its kernel of ``csrc/vit_block_int8.cu`` for CUDA tensors and counts the
launch in :data:`launches`; for CPU tensors it runs its ``*_plain`` twin.
Anything else raises. The kernels are also the ops
``hands_tpu_torch::i8_ln_quant_dynamic``, ``i8_ln_quant_static``,
``i8_quant_rows`` and ``i8_gemm`` (``cuda_build.KernelOp``), which a
``torch.export`` of the blocks records. The attention of both blocks is
:func:`hands_tpu_torch.ops.attention.qkv_attention`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from hands_tpu_torch.ops import quant
from hands_tpu_torch.ops.attention import qkv_attention, qkv_attention_plain
from hands_tpu_torch.ops.cuda_build import (CudaLibrary, KernelOp, check,
                                           check_gemm_operands, on_cpu)
from hands_tpu_torch.ops.vit_block import (check_layernorm_width, gelu,
                                           layernorm_f32)

_BF16, _F32, _I8 = torch.bfloat16, torch.float32, torch.int8

# kernel launches per wrapper since the last reset (CPU twin runs not counted)
launches: Dict[str, int] = {
    "ln_quant_dynamic": 0, "ln_quant_static": 0, "quant_rows": 0,
    "gemm_i8_dynamic": 0, "gemm_i8_static": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.i8_ln_quant.argtypes = [i, p, i, p, p, p, p, i, i, f, p]
    lib.i8_quant_rows.argtypes = [i, p, i, p, p, i, i, p]
    lib.i8_gemm.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    for fn in (lib.i8_ln_quant, lib.i8_quant_rows, lib.i8_gemm):
        fn.restype = ctypes.c_int


# -fmad=false: the f32 chains must round where the twins round, op by op
# but for the static dequantisation's one explicit fmaf (see the note at the
# top of the source)
LIBRARY = CudaLibrary("vit_block_int8", _bind, "i8_error_string",
                      extra_flags=("-fmad=false",))

# (dynamic?, epilogue, output dtype) -> the kernel's epilogue code
_GEMM_MODES = {
    (True, "bias", _BF16): 0, (True, "residual", _F32): 1,
    (True, "residual", _BF16): 2, (True, "gelu", _F32): 3,
    (False, "bias", _BF16): 4, (False, "residual", _BF16): 5,
    (False, "gelu", _I8): 6,
}
_MODE_DTYPES = {mode: dtype for (_, _, dtype), mode in _GEMM_MODES.items()}


# ------------------------------------------------------------- plain twins
def ln_quant_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   dynamic: bool, eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(R, C) bf16 or f32 -> LayerNorm in f32, then int8: per-row dynamic
    scales (returns (q, s (R, 1))) or a bare round/clip (returns (q, None))."""
    y = layernorm_f32(x.float(), scale, bias, eps)
    if dynamic:
        return quant.quant_rows_f32(y)
    return quant.quant_static(y), None


def quant_rows_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, K) bf16 or f32 -> (int8 (R, K), f32 (R, 1)) per-row scales."""
    return quant.quant_rows_f32(a.float())


def gemm_i8_plain(a_q, w_q, col_scale, bias, *, row_scale=None,
                  epilogue: str = "bias", residual=None, inv_next=None,
                  out_dtype=_BF16, fast_gelu: bool = False) -> torch.Tensor:
    """int8 ``a_q (M, K) . w_q (N, K)^T`` in int32, then in f32: dynamic
    (``row_scale`` (M, 1) given) ``acc * s_row * s_col`` op by op, then
    ``+ bias`` | ``(residual + .) + bias`` | ``gelu(. + bias)``; static
    ``acc * d_col + bias`` as one fused multiply-add
    (:func:`quant.dequant_static`), then nothing | ``residual + bf16(.)`` in
    bf16 | ``clip(round(gelu(.) * inv_next))`` as int8."""
    acc = quant.int_matmul(a_q, w_q)
    if row_scale is not None:
        v = acc.float() * row_scale * col_scale
        if epilogue == "residual":
            v = residual + v + bias
        else:
            v = v + bias
            if epilogue == "gelu":
                v = gelu(v, fast_gelu)
        return v.to(out_dtype)
    v = quant.dequant_static(acc, col_scale, bias)
    if epilogue == "residual":
        return residual + v.to(_BF16)
    if epilogue == "gelu":
        return quant.quant_static(gelu(v, fast_gelu) * inv_next)
    return v.to(_BF16)


# ------------------------------------------------------- kernel wrappers
# One launch function per kernel (checks, launch, count); each is the body of
# its torch.library op (cuda_build.KernelOp). The LayerNorm + quantise kernel
# has two ops, its dynamic form (rows and scales) and its static form (rows).
def _launch_ln_quant(x, scale, bias, dynamic: bool, eps: float):
    R, C = x.shape
    dev = x.device
    if x.dtype not in (_BF16, _F32):
        raise ValueError(f"ln_quant takes bf16 or f32 rows, got {x.dtype}")
    check_layernorm_width(C)
    check(x, "x", x.dtype, (R, C), dev)
    check(scale, "scale", _F32, (C,), dev)
    check(bias, "bias", _F32, (C,), dev)
    q = torch.empty((R, C), dtype=_I8, device=dev)
    s = torch.empty((R, 1), dtype=_F32, device=dev) if dynamic else None
    LIBRARY.launch("i8_ln_quant", dev, x.data_ptr(), int(x.dtype == _F32),
                   scale.data_ptr(), bias.data_ptr(), q.data_ptr(),
                   s.data_ptr() if dynamic else None, R, C, eps)
    launches["ln_quant_dynamic" if dynamic else "ln_quant_static"] += 1
    return q, s


def launch_ln_quant_dynamic(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_ln_quant(x, scale, bias, True, eps)


def launch_ln_quant_static(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float) -> torch.Tensor:
    return _launch_ln_quant(x, scale, bias, False, eps)[0]


def launch_quant_rows(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    R, K = a.shape
    dev = a.device
    if a.dtype not in (_BF16, _F32):
        raise ValueError(f"quant_rows takes bf16 or f32 rows, got {a.dtype}")
    check(a, "a", a.dtype, (R, K), dev)
    q = torch.empty((R, K), dtype=_I8, device=dev)
    s = torch.empty((R, 1), dtype=_F32, device=dev)
    LIBRARY.launch("i8_quant_rows", dev, a.data_ptr(), int(a.dtype == _F32),
                   q.data_ptr(), s.data_ptr(), R, K)
    launches["quant_rows"] += 1
    return q, s


def launch_gemm_i8(a_q: torch.Tensor, w_q: torch.Tensor,
                   col_scale: torch.Tensor, bias: torch.Tensor,
                   row_scale: Optional[torch.Tensor],
                   residual: Optional[torch.Tensor],
                   inv_next: Optional[torch.Tensor], mode: int,
                   fast_gelu: bool) -> torch.Tensor:
    M, K = a_q.shape
    N = w_q.shape[0]
    dev = a_q.device
    dynamic = row_scale is not None
    check_gemm_operands(a_q, w_q)
    check(a_q, "a_q", _I8, (M, K), dev)
    check(w_q, "w_q", _I8, (N, K), dev)
    check(col_scale, "col_scale", _F32, (N,), dev)
    check(bias, "bias", _F32, (N,), dev)
    if dynamic:
        check(row_scale, "row_scale", _F32, (M, 1), dev)
    if residual is not None:
        check(residual, "residual", _F32 if dynamic else _BF16, (M, N), dev)
    if inv_next is not None:
        check(inv_next, "inv_next", _F32, (N,), dev)
    out = torch.empty((M, N), dtype=_MODE_DTYPES[mode], device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    LIBRARY.launch("i8_gemm", dev, a_q.data_ptr(), w_q.data_ptr(),
                   ptr(row_scale), col_scale.data_ptr(), bias.data_ptr(),
                   ptr(residual), ptr(inv_next), out.data_ptr(), M, N, K,
                   mode, int(fast_gelu))
    launches["gemm_i8_dynamic" if dynamic else "gemm_i8_static"] += 1
    return out


def _rows_and_scales(x, *_):
    return (x.new_empty(x.shape, dtype=_I8),
            x.new_empty((x.shape[0], 1), dtype=_F32))


LN_QUANT_DYNAMIC = KernelOp("i8_ln_quant_dynamic", launch_ln_quant_dynamic,
                            _rows_and_scales)
LN_QUANT_STATIC = KernelOp(
    "i8_ln_quant_static", launch_ln_quant_static,
    lambda x, scale, bias, eps: x.new_empty(x.shape, dtype=_I8))
QUANT_ROWS = KernelOp("i8_quant_rows", launch_quant_rows, _rows_and_scales)
GEMM_I8 = KernelOp(
    "i8_gemm", launch_gemm_i8,
    lambda a_q, w_q, col_scale, bias, row_scale, residual, inv_next, mode,
    fast_gelu: a_q.new_empty((a_q.shape[0], w_q.shape[0]),
                             dtype=_MODE_DTYPES[mode]))


def ln_quant(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             dynamic: bool, eps: float = 1e-6
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """LayerNorm + quantise of (R, C) bf16 or f32 rows; see
    :func:`ln_quant_plain`."""
    if on_cpu(x):
        return ln_quant_plain(x, scale, bias, dynamic, eps)
    if dynamic:
        return LN_QUANT_DYNAMIC(x, scale, bias, eps)
    return LN_QUANT_STATIC(x, scale, bias, eps), None


def quant_rows(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantisation of (R, K) bf16 or f32."""
    if on_cpu(a):
        return quant_rows_plain(a)
    return QUANT_ROWS(a)


def gemm_i8(a_q, w_q, col_scale, bias, *, row_scale=None,
            epilogue: str = "bias", residual=None, inv_next=None,
            out_dtype=_BF16, fast_gelu: bool = False) -> torch.Tensor:
    """int8 (M, K) x (N, K)^T -> (M, N) with a dequantising epilogue; see
    :func:`gemm_i8_plain`. ``epilogue`` is ``"bias"``, ``"residual"`` or
    ``"gelu"``; ``row_scale`` selects the dynamic forms."""
    dynamic = row_scale is not None
    if not dynamic and epilogue == "gelu":
        out_dtype = _I8
    mode = _GEMM_MODES.get((dynamic, epilogue, out_dtype))
    if mode is None:
        raise ValueError(f"no int8 GEMM epilogue {epilogue!r} with "
                         f"dynamic={dynamic} and output {out_dtype}")
    if (residual is not None) != (epilogue == "residual"):
        raise ValueError("residual must be given exactly for "
                         "epilogue='residual'")
    if (inv_next is not None) != (mode == 6):
        raise ValueError("inv_next must be given exactly for the static "
                         "GELU epilogue")
    if on_cpu(a_q):
        return gemm_i8_plain(a_q, w_q, col_scale, bias, row_scale=row_scale,
                             epilogue=epilogue, residual=residual,
                             inv_next=inv_next, out_dtype=out_dtype,
                             fast_gelu=fast_gelu)
    return GEMM_I8(a_q, w_q, col_scale, bias, row_scale, residual, inv_next,
                   mode, fast_gelu)


# ------------------------------------------------------------------ blocks
def _block_dynamic(x, op, num_heads, fast_gelu, lnq, qrows, mm, attn):
    B, N, C = x.shape
    R = B * N
    x32 = x.float().reshape(R, C)
    qy, sy = lnq(x.reshape(R, C), op["ln1_s"], op["ln1_b"], True)
    qkv = mm(qy, op["wqkv_q"], op["sqkv"], op["bqkv"], row_scale=sy)
    o = attn(qkv.view(B, N, 3 * C), num_heads).view(R, C)
    qo, so = qrows(o)
    x1 = mm(qo, op["wproj_q"], op["sproj"], op["bproj"], row_scale=so,
            epilogue="residual", residual=x32, out_dtype=_F32)
    qy2, sy2 = lnq(x1, op["ln2_s"], op["ln2_b"], True)
    h = mm(qy2, op["w1_q"], op["s1"], op["b1"], row_scale=sy2,
           epilogue="gelu", out_dtype=_F32, fast_gelu=fast_gelu)
    qh, sh = qrows(h)
    out = mm(qh, op["w2_q"], op["s2"], op["b2"], row_scale=sh,
             epilogue="residual", residual=x1, out_dtype=_BF16)
    return out.view(B, N, C)


def _block_static(x, op, num_heads, fast_gelu, lnq, mm, attn):
    B, N, C = x.shape
    R = B * N
    x2 = x.reshape(R, C)
    qy, _ = lnq(x2, op["ln1_s"], op["ln1_b"], False)
    qkv = mm(qy, op["wqkv_q"], op["dqkv"], op["bqkv"])
    qo = attn(qkv.view(B, N, 3 * C), num_heads, op["inv_proj"]).view(R, C)
    x1 = mm(qo, op["wproj_q"], op["dproj"], op["bproj"], epilogue="residual",
            residual=x2)
    qy2, _ = lnq(x1, op["ln2_s"], op["ln2_b"], False)
    qh = mm(qy2, op["w1_q"], op["d1"], op["b1"], epilogue="gelu",
            inv_next=op["inv_mlp2"], fast_gelu=fast_gelu)
    out = mm(qh, op["w2_q"], op["d2"], op["b2"], epilogue="residual",
             residual=x1)
    return out.view(B, N, C)


def vit_block_int8_plain(x: torch.Tensor, op: dict, num_heads: int,
                         fast_gelu: bool = False) -> torch.Tensor:
    """The plain PyTorch twin of the dynamic W8A8 block (the arithmetic of
    ``_vit_block_int8_kernel``)."""
    return _block_dynamic(x.to(_BF16), op, num_heads, fast_gelu,
                          ln_quant_plain, quant_rows_plain, gemm_i8_plain,
                          qkv_attention_plain)


def vit_block_int8_static_plain(x: torch.Tensor, op: dict, num_heads: int,
                                fast_gelu: bool = False) -> torch.Tensor:
    """The plain PyTorch twin of the static W8A8 block (port of
    ``block_int8_static_xla``)."""
    return _block_static(x.to(_BF16), op, num_heads, fast_gelu,
                         ln_quant_plain, gemm_i8_plain, qkv_attention_plain)


def vit_block_fused_int8(x: torch.Tensor, op: dict, *, num_heads: int,
                         fast_gelu: bool = False) -> torch.Tensor:
    """Dynamic W8A8 block: (B, N, C) bf16 tokens -> (B, N, C) bf16. ``op`` is
    the dict of ``quant.prepare_int8``. CUDA tensors run the kernels (9
    launches), CPU tensors the twin."""
    return _block_dynamic(x.to(_BF16), op, num_heads, fast_gelu, ln_quant,
                          quant_rows, gemm_i8, qkv_attention)


def vit_block_fused_int8_static(x: torch.Tensor, op: dict, *, num_heads: int,
                                fast_gelu: bool = False) -> torch.Tensor:
    """Static-calibrated W8A8 block: (B, N, C) bf16 -> (B, N, C) bf16. ``op``
    is the dict of ``quant.fold_static_scales``. CUDA tensors run the kernels
    (7 launches), CPU tensors the twin."""
    return _block_static(x.to(_BF16), op, num_heads, fast_gelu, ln_quant,
                         gemm_i8, qkv_attention)
