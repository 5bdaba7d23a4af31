"""Fused multi-head attention: a hand-written CUDA kernel and its plain
PyTorch twins (port of ``hands_tpu/ops/attention_pallas.py:mha_fused`` and of
the attention legs of the two int8 block kernels of
``hands_tpu/ops/vit_block_pallas.py``).

:func:`mha_fused` is the ``ViTBackbone(fused_attn=True)`` path:
``softmax(q k^T * scale) v`` per (batch row, head) on (B, N, H, D) tensors,
f32 logits with the scale applied in f32 after the dot, probabilities cast to
``v.dtype``, f32 accumulation, output in ``q.dtype``. :func:`qkv_attention`
is the attention of the int8 blocks on a fused bf16 (B, N, 3C) qkv tensor:
``q * bf16(D^-0.5)`` rounded to bf16, f32 logits that are *not* rounded to
bf16, an f32 softmax; the dynamic block keeps f32 probabilities and returns
bf16, the static block rounds the probabilities to bf16 and returns the
output times ``inv_out`` quantised to int8.

CUDA tensors launch the kernel of ``csrc/attention.cu`` (one launch, counted
in :data:`launches`): bf16 on the bf16 tensor cores; f32 (``mha_fused``
only) as 3xTF32 on the TF32 tensor cores where a head has at most 256 tokens
and head dim 128 and its K and V fit in shared memory, else on the CUDA-core
loop where that fits (:func:`f32_route`); the int8 blocks' modes are also the
op ``hands_tpu_torch::qkv_attention`` (``cuda_build.KernelOp``), which a
``torch.export`` of those blocks records; CPU tensors run the ``*_plain``
twin; anything else raises, and so does a shape past the limits of the bf16
route (:func:`~hands_tpu_torch.ops.vit_block.check_attention_shape`) or past
the shared memory of both f32 routes. q, k and v are read in place through
their strides, so the slices of a fused qkv tensor are not copied.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from hands_tpu_torch.ops.cuda_build import (CudaLibrary, KernelOp, check,
                                           on_cpu)
from hands_tpu_torch.ops.vit_block import bf16_const, check_attention_shape

_BF16 = torch.bfloat16
_MODE_MHA, _MODE_DYNAMIC, _MODE_STATIC, _MODE_MHA_CORES = 0, 1, 2, 7
_SMEM_MAX = 232448  # bytes of shared memory a Hopper thread block can have
_TF32_MAX_N, _TF32_MAX_D = 256, 128  # a row of logits in registers

# kernel launches per wrapper since the last reset (CPU twin runs not
# counted); f32 mha_fused by route: the tensor cores, the CUDA-core loop
launches: Dict[str, int] = {"mha_fused": 0, "mha_fused_f32": 0,
                            "mha_fused_f32_cores": 0,
                            "qkv_attention_dynamic": 0,
                            "qkv_attention_static": 0}
_F32_COUNT = {_MODE_MHA: "mha_fused_f32",
              _MODE_MHA_CORES: "mha_fused_f32_cores"}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.attn_fused.argtypes = [i, p, p, p, p, p, i, i, i, i, ll, ll, f, i, i,
                               p]
    lib.attn_fused.restype = ctypes.c_int


LIBRARY = CudaLibrary("attention", _bind, "attn_error_string")


# ------------------------------------------------------------- plain twins
def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """(B, N, H, D) q, k, v -> (B, N, H, D): the arithmetic of
    ``_mha_kernel``."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    attn = (p / torch.sum(p, dim=-1, keepdim=True)).to(v.dtype)
    out = torch.matmul(attn.float(), vh.float())
    return out.to(q.dtype).permute(0, 2, 1, 3)


def qkv_attention_plain(qkv: torch.Tensor, num_heads: int,
                        inv_out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, N, 3C) bf16 fused qkv -> (B, N, C): bf16 (dynamic int8 block) or,
    with ``inv_out`` (C,), int8 (static int8 block)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    t = qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)  # (3,B,H,N,D)
    q = t[0] * bf16_const(D**-0.5)
    s = torch.matmul(q.float(), t[1].float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    if inv_out is not None:
        p = p.to(_BF16).float()
    o = torch.matmul(p, t[2].float())  # (B, H, N, D) f32
    o = o.permute(0, 2, 1, 3).reshape(B, N, C)
    if inv_out is None:
        return o.to(_BF16)
    return torch.clamp(torch.round(o * inv_out), -127.0, 127.0).to(torch.int8)


# ------------------------------------------------------- kernel wrappers
def _strides(t: torch.Tensor, B: int, N: int, H: int, D: int):
    """(batch stride, row stride) in elements of a (B, N, H, D) tensor whose
    heads lie side by side; raises on a layout the kernel cannot read."""
    sb, sn, sh, sd = t.stride()
    if sd != 1 or (H > 1 and sh != D) or t.shape != (B, N, H, D):
        raise ValueError(
            f"attention kernel needs (B, N, H, D) with unit channel stride "
            f"and adjacent heads, got shape {tuple(t.shape)} strides "
            f"{t.stride()}")
    return (sb if B > 1 else N * sn), sn


def _launch(q, k, v, out, inv_out, B, N, H, D, scale, mode) -> None:
    dev = q.device
    qs = _strides(q, B, N, H, D)
    for name, t in (("k", k), ("v", v)):
        if (t.device != dev or t.dtype != q.dtype
                or _strides(t, B, N, H, D) != qs):
            raise ValueError(f"{name}: want q's device, dtype and strides")
    if q.dtype == _BF16:
        check_attention_shape(N, D)
        if qs[0] % 8 or qs[1] % 8 or any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bf16 attention kernel needs 16-byte aligned q, "
                             "k, v and strides that are multiples of 8 "
                             "elements")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("attention kernel needs 4-byte aligned q, k, v")
    LIBRARY.launch(
        "attn_fused", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if inv_out is None else inv_out.data_ptr(),
        B, N, H, D, qs[0], qs[1], scale, int(q.dtype == torch.float32), mode)


def _tf32_smem(N: int, D: int) -> int:
    """Bytes of shared memory of the tensor-core f32 route: K and V of a
    head, keys padded to 8, channels to 8, rows to 8 mod 16 (K) and 4 mod 8
    (V) floats (``csrc/attention_f32.cuh:tf32_smem``)."""
    npad, dp = -(-N // 8) * 8, -(-D // 8) * 8
    return 4 * npad * ((dp if dp % 16 else dp + 8) + dp + 4)


def _cores_smem(N: int, D: int) -> int:
    """Bytes of shared memory of the CUDA-core f32 route: K rows of D + 1
    floats, V, and the q and p rows of its 8 warps."""
    return 4 * (N * (2 * D + 1) + 8 * (D + N))


def f32_route(N: int, D: int) -> int:
    """The kernel mode of f32 ``mha_fused`` for heads of N tokens, dim D:
    the tensor cores (3xTF32) up to 256 tokens and head dim 128 where K and V
    fit in shared memory, else the CUDA-core loop where its buffers fit;
    raises past both."""
    if (N <= _TF32_MAX_N and D <= _TF32_MAX_D
            and _tf32_smem(N, D) <= _SMEM_MAX):
        return _MODE_MHA
    if _cores_smem(N, D) <= _SMEM_MAX:
        return _MODE_MHA_CORES
    raise ValueError(
        f"the f32 attention routes hold K and V of a head in shared memory: "
        f"the tensor-core route takes N <= {_TF32_MAX_N}, D <= "
        f"{_TF32_MAX_D} within {_SMEM_MAX} bytes, the CUDA-core route N (2D "
        f"+ 1) + 8 (D + N) floats within them; got N={N}, D={D}")


def _mha(q, k, v, scale, mode) -> torch.Tensor:
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, None, B, N, H, D, float(scale), mode)
    launches[_F32_COUNT[mode] if q.dtype == torch.float32
             else "mha_fused"] += 1
    return out


def mha_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Softmax(q k^T * scale) v; (B, N, H, D) in and out (the layout of the
    reshaped fused qkv projection), f32 or bf16."""
    if on_cpu(q):
        return mha_plain(q, k, v, scale)
    if q.dtype not in (_BF16, torch.float32):
        raise ValueError(f"mha_fused takes bf16 or f32, got {q.dtype}")
    _, N, _, D = q.shape
    return _mha(q, k, v, scale,
                f32_route(N, D) if q.dtype == torch.float32 else _MODE_MHA)


def mha_f32_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """f32 ``mha_fused`` on the CUDA-core loop whatever the shape (CUDA
    tensors only): the route that the tensor-core one replaced where both
    take a shape, for holding the two side by side."""
    if q.device.type != "cuda" or q.dtype != torch.float32:
        raise ValueError("mha_f32_cores takes f32 CUDA tensors")
    _, N, _, D = q.shape
    if _cores_smem(N, D) > _SMEM_MAX:
        raise ValueError(f"the CUDA-core route's shared memory: N={N}, D={D}")
    return _mha(q, k, v, scale, _MODE_MHA_CORES)


def launch_qkv_attention(qkv: torch.Tensor, num_heads: int,
                         inv_out: Optional[torch.Tensor]) -> torch.Tensor:
    """The launch function of the int8 blocks' attention (checks, launch,
    count): the body of the op ``hands_tpu_torch::qkv_attention``."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    dev = qkv.device
    if C3 % 3 or C % num_heads:
        raise ValueError(f"attention kernel needs 3C columns, got {C3} "
                         f"columns, {num_heads} heads")
    check(qkv, "qkv", _BF16, (B, N, C3), dev)
    t = qkv.view(B, N, 3, num_heads, D)
    static = inv_out is not None
    if static:
        check(inv_out, "inv_out", torch.float32, (C,), dev)
    out = torch.empty((B, N, C), device=dev,
                      dtype=torch.int8 if static else _BF16)
    _launch(t[:, :, 0], t[:, :, 1], t[:, :, 2], out, inv_out, B, N,
            num_heads, D, bf16_const(D**-0.5),
            _MODE_STATIC if static else _MODE_DYNAMIC)
    launches["qkv_attention_static" if static
             else "qkv_attention_dynamic"] += 1
    return out


QKV_ATTENTION = KernelOp(
    "qkv_attention", launch_qkv_attention,
    lambda qkv, num_heads, inv_out: qkv.new_empty(
        (*qkv.shape[:2], qkv.shape[2] // 3),
        dtype=_BF16 if inv_out is None else torch.int8))


def qkv_attention(qkv: torch.Tensor, num_heads: int,
                  inv_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the int8 blocks on a fused (B, N, 3C) bf16 qkv tensor ->
    (B, N, C) bf16, or int8 when ``inv_out`` (C,) f32 is given."""
    if on_cpu(qkv):
        return qkv_attention_plain(qkv, num_heads, inv_out)
    return QKV_ATTENTION(qkv, num_heads, inv_out)
