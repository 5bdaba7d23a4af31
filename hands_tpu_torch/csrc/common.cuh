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

#include <type_traits>

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

// --------------------------------------------------- a warp per row
// The LayerNorm passes (vit_block.cu's layernorm_kernel, vit_block_int8.cu's
// ln_quant_kernel, vit_block_ablation.cu's ln_ablation_kernel) give each row
// to one warp, WARP_ROWS rows a block, and hold it in registers: lane l
// keeps NV vectors of 4 values (8 bytes of bf16 or 16 of f32), vector i
// being the row's values 4 (32 i + l) ... + 3; vectors past the row's end
// are zeros. The row is read once; the
// statistics are warp shuffles, with no shared memory and no barrier.
constexpr int WARP_ROWS = 8;
constexpr int WARP_ROW_MAX_C = 2048;  // the widest row the registers hold

__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
}

// Reads row `xr` of C values (C a multiple of 4) into v and returns its
// mean and the mean of its squares in flax LayerNorm's f32 rounding order:
// E[.] = sum * RN(1/C) (XLA compiles jnp.mean's division by the constant C
// so), each square rounded before its add. The sums run in the order of
// PyTorch's CUDA row reduction, the twins' on the card, for C > 128 and 16
// rows or more: each lane keeps one accumulator a vector element and
// combines them as ((a0 + a1) + a2) + a3; the 32 lane sums meet in
// warp_sum's xor butterfly over 16, 8, 4, 2, 1 (lane l with l + 16 first, as
// shfl_down does; every step gives all lanes the same sum). Then
// chip_smoke.py finds ln_quant and the LayerNorm bit-equal to their twins;
// in another order an int8 step in 1e6 moved, and each moved step of the
// first LayerNorm reaches a whole image through the attention.
template <typename T, int NV>
__device__ __forceinline__ void warp_row_moments(const T* __restrict__ xr,
                                                 int C, float (&v)[NV][4],
                                                 float& mu, float& m2) {
  const int lane = threadIdx.x % 32, nvec = C / 4;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, aa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec) {
      load4(xr + (size_t)vi * 4, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = __fadd_rn(a[j], v[i][j]);
      aa[j] = __fadd_rn(aa[j], __fmul_rn(v[i][j], v[i][j]));
    }
  }
  const float s = warp_sum(
      __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]));
  const float ss = warp_sum(
      __fadd_rn(__fadd_rn(__fadd_rn(aa[0], aa[1]), aa[2]), aa[3]));
  const float inv_c = 1.f / (float)C;
  mu = __fmul_rn(s, inv_c);
  m2 = __fmul_rn(ss, inv_c);
}

// warp_row_moments, then the fast variance max(E[x^2] - E[x]^2, 0) (the
// product rounded) and r = rsqrt(var + eps)
template <typename T, int NV>
__device__ __forceinline__ void warp_row_stats(const T* __restrict__ xr,
                                               int C, float eps,
                                               float (&v)[NV][4], float& mu,
                                               float& r) {
  float m2;
  warp_row_moments<T, NV>(xr, C, v, mu, m2);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.f);
  r = rsqrtf(var + eps);
}

// Returns f(std::integral_constant<int, NV>()) for the NV that holds a row
// of C values (C / 4 vectors over 32 lanes), rounded up to the sizes that
// are compiled: 1-6, 8, 10, 12, 16
template <typename F>
int with_row_vectors(int C, F f) {
  switch ((C / 4 + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7:
    case 8: return f(std::integral_constant<int, 8>());
    case 9:
    case 10: return f(std::integral_constant<int, 10>());
    case 11:
    case 12: return f(std::integral_constant<int, 12>());
    default: return f(std::integral_constant<int, 16>());
  }
}

// (x - mu) * (r * scale) + bias, each step rounded (no contraction)
__device__ __forceinline__ float ln_affine(float x, float mu, float r,
                                          float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mu), __fmul_rn(r, scale)), bias);
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
