"""W8A8 int8 quantisation primitives for serving (port of the helpers of
``hands_tpu/ops/vit_block_pallas.py`` and of ``hands_tpu/ops/quant.py``).

Scheme: symmetric int8, weights with per-output-channel scales, activations
per token (dynamic) or per channel (static, calibrated offline and folded
into the LayerNorm parameters and the weights by :func:`fold_static_scales`).
``torch.round`` rounds half to even, as ``jnp.round`` does.

Layout: the port keeps matmul weights as ``nn.Linear`` does, (out, in); the
JAX package keeps (in, out). Every function here takes and returns the
port's layout, so ``quantize_weight_int8(w)[0]`` is the transpose of the JAX
function's int8 matrix.

A scale ``amax / 127.0 + 1e-12`` is computed as one fused multiply-add,
``fma(amax, float32(1 / 127), 1e-12)``: XLA turns the division by a constant
into a multiplication and contracts it with the addition inside the jitted
JAX block functions. Against the op-by-op value this moves one scale in ten
by an f32 ulp when the scales are small (folded weights), and with it now
and then an int8 weight, which is visible in a block's output.

:func:`int8_conv` / :class:`Int8Conv` are the W8A8 serving convolution of the
ResNet backbones: per-sample dynamic activation scales, per-output-channel
weight scales, exact int32 accumulation, dequantisation by their product. In
the JAX package this product is XLA's, outside any Pallas kernel, so a library
product computes it here: ``torch._int_mm`` on the unfolded patches on the
card, an f64 convolution of the integer values on the CPU (exact:
127^2 * 4608 < 2^53; f32 is not). Tensors are NCHW and kernels OIHW, the
port's layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_INV127 = float(np.float32(1.0) / np.float32(127.0))
_EPS = float(np.float32(1e-12))


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """``fma(amax, 1/127, 1e-12)`` in f32: the f32 product is exact in f64,
    so one f64 multiply-add rounded to f32 is the fused result."""
    return (amax.double() * _INV127 + _EPS).float()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as one fused multiply-add (torch has
    none). The product of two f32 values is exact in f64; the f64 sum is
    made round-to-odd (TwoSum gives its error, and an inexact even result
    steps one ulp toward the exact value), so rounding it to f32 rounds the
    exact value once: 53 bits leave the two to spare that this needs."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    toward = torch.copysign(torch.full_like(s, torch.inf), err)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def dequant_static(acc: torch.Tensor, d: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """The static dequantisation ``f32(acc) * d + b`` of an int32 product as
    one fused multiply-add, as XLA contracts it in the JAX kernels and as the
    CUDA kernels evaluate it (``csrc/common.cuh:dequant_static``)."""
    return fma_f32(acc.float(), d, b)


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 (out, in), f32 (out,)) symmetric
    per-output-channel scales: ``s = max|w| / 127 + 1e-12``,
    ``q = round(w / s)``."""
    w32 = w.float()
    s = scale_from_amax(torch.amax(torch.abs(w32), dim=1))
    return torch.round(w32 / s[:, None]).to(torch.int8), s


def quant_rows_f32(a32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (per-token) dynamic int8 quantisation of a 2-D f32
    tensor (port of ``_quant_rows_f32``): (int8 (R, K), f32 (R, 1))."""
    s = scale_from_amax(torch.amax(torch.abs(a32), dim=-1, keepdim=True))
    q = torch.clamp(torch.round(a32 / s), -127.0, 127.0).to(torch.int8)
    return q, s


def quant_static(a32: torch.Tensor) -> torch.Tensor:
    """Quantise an f32 tensor already expressed in the quantised domain (the
    static 1/scale is folded into the producing op): round, clip, cast."""
    return torch.clamp(torch.round(a32), -127.0, 127.0).to(torch.int8)


def quantize_int8(x: torch.Tensor, axes: Optional[Sequence[int]] = None,
                  eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation. Returns (q, scale) with
    ``x ~= q * scale``; ``axes`` are the reduction axes of the max-abs
    (None -> per tensor)."""
    x32 = x.float()
    if axes is None:
        amax = torch.amax(torch.abs(x32))
        shape = [1] * x.ndim
    else:
        amax = torch.amax(torch.abs(x32), dim=tuple(axes))
        shape = [1 if i in axes else x.shape[i] for i in range(x.ndim)]
    scale = torch.clamp(amax, min=eps) * _INV127
    q = torch.clamp(torch.round(x32 / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def int_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 ``a_q (M, K) . w_q (N, K)^T`` -> int32 (M, N) for the plain
    twins. The CPU has no int8 product and f32 is not exact at K = 5120, so
    it runs in int32 there; on CUDA it is one ``torch._int_mm`` where that
    call takes the shape, else an f64 product (exact below 2^53)."""
    if a_q.device.type == "cpu":
        return torch.matmul(a_q.to(torch.int32), w_q.to(torch.int32).t())
    M, K = a_q.shape
    N = w_q.shape[0]
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        return torch._int_mm(a_q, w_q.t())
    return torch.matmul(a_q.double(), w_q.double().t()).to(torch.int32)


def prepare_int8(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The flat block dict (``ops.vit_block.block_params`` naming, f32
    values) -> the operands of ``vit_block_fused_int8``: the four weights
    quantised per output channel (what the JAX wrapper does on every call,
    done once here), biases and LayerNorm parameters in f32."""
    wqkv_q, sqkv = quantize_weight_int8(params["wqkv"])
    wproj_q, sproj = quantize_weight_int8(params["wproj"])
    w1_q, s1 = quantize_weight_int8(params["w1"])
    w2_q, s2 = quantize_weight_int8(params["w2"])
    return {
        "ln1_s": params["ln1_scale"].float(), "ln1_b": params["ln1_bias"].float(),
        "wqkv_q": wqkv_q, "sqkv": sqkv, "bqkv": params["bqkv"].float(),
        "wproj_q": wproj_q, "sproj": sproj, "bproj": params["bproj"].float(),
        "ln2_s": params["ln2_scale"].float(), "ln2_b": params["ln2_bias"].float(),
        "w1_q": w1_q, "s1": s1, "b1": params["b1"].float(),
        "w2_q": w2_q, "s2": s2, "b2": params["b2"].float(),
    }


def fold_static_scales(params: Dict[str, torch.Tensor],
                       act_scales: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Fold per-channel static activation scales into the block operands
    (port of ``fold_static_scales``).

    ``act_scales``: ``qkv`` (C,), ``proj`` (C,), ``mlp1`` (C,), ``mlp2``
    (hidden,) f32 scales (quantised value = x / s) from
    ``ops/calibration.py``. Returns the operands of
    ``vit_block_fused_int8_static``:

    - LayerNorm scale/bias divided by the consumer's activation scale (the
      LayerNorm output lands in the quantised domain),
    - weights premultiplied by diag(s_act) along the contraction axis, then
      quantised per output channel (the activation scales ride the
      per-column dequantisation multiply),
    - 1/s vectors for the two points whose producer is not a LayerNorm
      (attention output, GELU output).

    Weight-sized elementwise work: do it once per set of weights and scales.
    """
    s_qkv = act_scales["qkv"].float()
    s_proj = act_scales["proj"].float()
    s_mlp1 = act_scales["mlp1"].float()
    s_mlp2 = act_scales["mlp2"].float()

    def absorb(w, s_in):
        return quantize_weight_int8(w.float() * s_in[None, :])

    wqkv_q, dqkv = absorb(params["wqkv"], s_qkv)
    wproj_q, dproj = absorb(params["wproj"], s_proj)
    w1_q, d1 = absorb(params["w1"], s_mlp1)
    w2_q, d2 = absorb(params["w2"], s_mlp2)
    return {
        "ln1_s": params["ln1_scale"].float() / s_qkv,
        "ln1_b": params["ln1_bias"].float() / s_qkv,
        "wqkv_q": wqkv_q, "dqkv": dqkv, "bqkv": params["bqkv"].float(),
        "inv_proj": 1.0 / s_proj,
        "wproj_q": wproj_q, "dproj": dproj, "bproj": params["bproj"].float(),
        "ln2_s": params["ln2_scale"].float() / s_mlp1,
        "ln2_b": params["ln2_bias"].float() / s_mlp1,
        "w1_q": w1_q, "d1": d1, "b1": params["b1"].float(),
        "inv_mlp2": 1.0 / s_mlp2,
        "w2_q": w2_q, "d2": d2, "b2": params["b2"].float(),
    }


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """Exact convolution of int8 NCHW ``xq`` with int8 OIHW ``wq`` -> int32
    values (returned as f32 on the CPU, where they come from an f64
    convolution, and as int32 on the card)."""
    if xq.device.type == "cpu":
        return F.conv2d(xq.double(), wq.double(), stride=stride,
                        padding=padding)
    N, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    oh = (H + 2 * padding - kh) // stride + 1
    ow = (W + 2 * padding - kw) // stride + 1
    if kh == 1 and kw == 1 and padding == 0:
        rows = xq[:, :, ::stride, ::stride].permute(0, 2, 3, 1).reshape(-1, C)
    else:
        # im2col; int8 values are exact in bf16, which unfold takes
        cols = F.unfold(xq.to(torch.bfloat16), (kh, kw), padding=padding,
                        stride=stride)  # (N, C*kh*kw, L)
        rows = cols.transpose(1, 2).reshape(N * oh * ow, C * kh * kw).to(
            torch.int8)
    w2 = wq.reshape(O, -1)
    # torch._int_mm takes M > 16 and K, N multiples of 8: zero-pad to that
    M, K = rows.shape
    pm, pk, po = max(17 - M, 0), -K % 8, -O % 8
    rows = F.pad(rows, (0, pk, 0, pm)).contiguous()
    w2 = F.pad(w2, (0, pk, 0, po))
    out = torch._int_mm(rows, w2.t())[:M, :O]
    return out.reshape(N, oh, ow, O).permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
              padding: int, out_dtype=torch.float32) -> torch.Tensor:
    """W8A8 convolution of NCHW ``x`` with the f32 OIHW ``kernel``: both
    quantised here (activations per sample, weights per output channel),
    int32 accumulation, dequantised by ``act_scale[n] * w_scale[o]``."""
    xq, sx = quantize_int8(x, axes=(1, 2, 3))
    wq, sw = quantize_int8(kernel, axes=(1, 2, 3))
    acc = _int_conv(xq, wq, stride, padding)
    scale = sx[:, None, None, None] * sw[None, :, None, None]
    return (acc.to(torch.float32) * scale).to(out_dtype)


class Int8Conv(nn.Module):
    """Drop-in W8A8 serving twin of the bias-free ``Conv`` of
    ``models/backbones/resnet.py``: same parameter name and shape, so the same
    weights load into either."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel, kernel, device=device))

    def forward(self, x):
        return int8_conv(x, self.weight, self.stride, self.padding,
                         out_dtype=self.dtype)


def serving_conv_cls(quant_int8: bool):
    """The convolution class of a serving config: :class:`Int8Conv` under
    ``Config.quant_int8``, the plain ``Conv`` otherwise."""
    if quant_int8:
        return Int8Conv
    from hands_tpu_torch.models.backbones.resnet import Conv

    return Conv
