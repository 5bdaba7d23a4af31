// Device helpers shared by the bf16 block (vit_block.cu), the int8 block
// kernels (vit_block_int8.cu), the attention kernels (attention.cu) and their
// knock-out variants (vit_block_ablation.cu): conversions, the two int8
// stores (round and clip, or the bare cast), the static dequantisation,
// warp and block reductions, 16-byte cp.async copies, and the f32 GELUs.
// Everything lives in an anonymous namespace: each source is built into a
// library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float INV127 = 1.0f / 127.0f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// _quant_static: round half to even, clip to [-127, 127]
__device__ __forceinline__ float quant_clip(float v) {
  return fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// The static dequantisation acc * d + b as one fused multiply-add, rounded
// once, as XLA contracts it in the JAX kernels. An explicit fmaf stays fused
// under -fmad=false, which the int8 sources need for their other chains.
__device__ __forceinline__ float dequant_static(int acc, float d, float b) {
  return fmaf((float)acc, d, b);
}

// The bare f32 -> int8 cast as XLA compiles it: truncation toward zero,
// saturation at [-128, 127], NaN -> 0. __float2int_rz truncates, saturates at
// the int32 range and sends NaN to 0; the clamp does the rest.
__device__ __forceinline__ int8_t cast_i8(float v) {
  return (int8_t)min(max(__float2int_rz(v), -128), 127);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy that bypasses registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: 16 zero bytes (masked edge)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int ROW_THREADS = 256;

// Sum (IS_MAX = false) or maximum over the thread block; every thread gets
// the result. `red` holds one float per warp.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < ROW_THREADS / 32 ? red[lane] : 0.f;  // maxima are of |.| >= 0
  return IS_MAX ? warp_max(v) : warp_sum(v);
}

// f32 exact GELU 0.5x * erfc(-x * 2^-0.5), op by op as jax.nn.gelu lowers it
__device__ __forceinline__ float gelu_erfc_f32(float x) {
  const float half_x = 0.5f * x;
  const float d = -x * 0.7071067811865476f;  // f32(2^-0.5)
  return half_x * erfcf(d);
}

// f32 tanh GELU x * (0.5 * (1 + tanh(c * (x + k * x^3)))), op by op
__device__ __forceinline__ float gelu_tanh_f32(float x) {
  const float x3 = x * (x * x);
  const float inner = 0.7978845608028654f * (x + 0.044715f * x3);
  return x * (0.5f * (1.0f + tanhf(inner)));
}

}  // namespace
