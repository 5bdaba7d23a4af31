// Fused multi-head attention for NVIDIA Hopper (sm_90a): softmax(q k^T) v per
// (crop, head) with nothing but q, k, v in and o out touching device memory.
// Plain C interface, built with nvcc and loaded with ctypes by
// hands_tpu_torch/ops/attention.py.
//
// Replaces: hands_tpu/ops/attention_pallas.py:52 mha_fused (pl.pallas_call at
// :58, body _mha_kernel at :27), and the attention legs of the two int8 block
// kernels, hands_tpu/ops/vit_block_pallas.py:239-250 (_vit_block_int8_kernel)
// and :342-355 (_vit_block_int8_static_kernel). Three modes, one kernel:
//   MODE_MHA      f32 logits of the raw q, k, times `scale` in f32 after the
//                 dot; probabilities cast to the input type; f32 accumulate;
//                 output in the input type (bf16 or f32)
//   MODE_DYNAMIC  bf16 only: q * scale rounded to bf16 first (`scale` is the
//                 bf16 value of D^-0.5), f32 logits, f32 probabilities, bf16 out
//   MODE_STATIC   as MODE_DYNAMIC but probabilities rounded to bf16 and the
//                 output times inv_out[h*D + d], rounded half to even, clipped
//                 to [-127, 127] and stored as int8
// q, k and v are read in place through a batch stride and a row stride (in
// elements), so the three slices of a fused (B, N, 3, H, D) qkv tensor need no
// copies; head h starts h*D elements into a row. The TPU wrapper's (B,H,N,D)
// transposes are a tiling need of that chip and are not reproduced.
//
// What bounds it on this card: at N = 192, D = 80 a head reads 3 x 30 KB
// (bf16) and does 4*N*N*D = 11.8 MFLOP, 130 FLOP per byte, below the bf16
// ridge but on the f32 CUDA cores (67 TFLOP/s) it is operation-bound. What
// this simple design does about it: one thread block per (crop, head) with K
// and V of the head in shared memory, one warp per query row, lanes over keys
// for the logits and over channels for p.v. No tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

enum { MODE_MHA = 0, MODE_DYNAMIC = 1, MODE_STATIC = 2 };
constexpr int ATTN_THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__host__ __device__ constexpr int k_pad() {
  // K rows padded to an odd number of 32-bit words: lanes reading different
  // rows hit different banks
  return sizeof(T) == 2 ? 2 : 1;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(ATTN_THREADS) attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    void* __restrict__ out, const float* __restrict__ inv_out, int N, int H,
    int D, long long batch_stride, long long row_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool ROUND_P =
      MODE == MODE_STATIC || (MODE == MODE_MHA && sizeof(T) == 2);
  const int C = H * D;
  const int KD = D + k_pad<T>();
  const int nwarps = ATTN_THREADS / 32;
  T* Ks = reinterpret_cast<T*>(smem_raw);  // N x KD
  T* Vs = Ks + (size_t)N * KD;             // N x D
  float* qbuf = reinterpret_cast<float*>(Vs + (size_t)N * D);  // nwarps x D
  float* pbuf = qbuf + nwarps * D;                             // nwarps x N

  const int h = blockIdx.x;
  const size_t base = (size_t)blockIdx.y * batch_stride + (size_t)h * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int idx = threadIdx.x; idx < N * D; idx += ATTN_THREADS) {
    const int m = idx / D, d = idx % D;
    Ks[(size_t)m * KD + d] = kb[(size_t)m * row_stride + d];
    Vs[(size_t)m * D + d] = vb[(size_t)m * row_stride + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = qbuf + warp * D;
  float* p = pbuf + warp * N;
  for (int n = warp; n < N; n += nwarps) {
    const T* qrow = qb + (size_t)n * row_stride;
    for (int d = lane; d < D; d += 32) {
      const float qv = to_float(qrow[d]);
      qs[d] = MODE == MODE_MHA ? qv : round_bf16(qv * scale);
    }
    __syncwarp();

    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) {
      const T* krow = Ks + (size_t)m * KD;
      float s = 0.f;
      if constexpr (sizeof(T) == 2) {  // bf16 pairs (the wrapper checks D % 2)
        const __nv_bfloat162* kr2 =
            reinterpret_cast<const __nv_bfloat162*>(krow);
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kv = __bfloat1622float2(kr2[d2]);
          s = fmaf(qs[2 * d2], kv.x, s);
          s = fmaf(qs[2 * d2 + 1], kv.y, s);
        }
      } else {
        for (int d = 0; d < D; ++d) s = fmaf(qs[d], to_float(krow[d]), s);
      }
      if (MODE == MODE_MHA) s = s * scale;
      p[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float e = expf(p[m] - mx);
      p[m] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int m = lane; m < N; m += 32) {
      const float pr = p[m] / sum;
      p[m] = ROUND_P ? round_bf16(pr) : pr;
    }
    __syncwarp();

    const size_t orow = ((size_t)blockIdx.y * N + n) * C + (size_t)h * D;
    for (int d = lane; d < D; d += 32) {
      float o = 0.f;
      for (int m = 0; m < N; ++m)
        o = fmaf(p[m], to_float(Vs[(size_t)m * D + d]), o);
      if (MODE == MODE_STATIC) {
        const float r = rintf(__fmul_rn(o, inv_out[h * D + d]));
        reinterpret_cast<int8_t*>(out)[orow + d] =
            (int8_t)fminf(fmaxf(r, -127.f), 127.f);
      } else if (sizeof(T) == 2) {
        reinterpret_cast<bf16*>(out)[orow + d] = __float2bfloat16_rn(o);
      } else {
        reinterpret_cast<float*>(out)[orow + d] = o;
      }
    }
    __syncwarp();
  }
}

template <typename T>
size_t smem_bytes(int N, int D) {
  return (size_t)N * (D + k_pad<T>()) * sizeof(T) +
         (size_t)N * D * sizeof(T) +
         (size_t)(ATTN_THREADS / 32) * (D + N) * sizeof(float);
}

template <typename T, int MODE>
int launch(const void* q, const void* k, const void* v, void* out,
           const float* inv_out, int B, int N, int H, int D,
           long long batch_stride, long long row_stride, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T, MODE><<<dim3(H, B), ATTN_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, out, inv_out, N, H, D,
      batch_stride, row_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------------------------------- C interface
extern "C" {

// is_f32: element type of q, k, v (and of out in MODE_MHA). Returns the
// launch's cudaGetLastError() (0 = success), cudaErrorInvalidValue for a
// combination the kernel does not have; never synchronises.
int attn_fused(int device, const void* q, const void* k, const void* v,
               void* out, const void* inv_out, int B, int N, int H, int D,
               long long batch_stride, long long row_stride, float scale,
               int is_f32, int mode, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* inv = (const float*)inv_out;
  if (mode == MODE_MHA && is_f32)
    return launch<float, MODE_MHA>(q, k, v, out, inv, B, N, H, D,
                                   batch_stride, row_stride, scale, s);
  if (mode == MODE_MHA)
    return launch<bf16, MODE_MHA>(q, k, v, out, inv, B, N, H, D,
                                  batch_stride, row_stride, scale, s);
  if (mode == MODE_DYNAMIC && !is_f32)
    return launch<bf16, MODE_DYNAMIC>(q, k, v, out, inv, B, N, H, D,
                                      batch_stride, row_stride, scale, s);
  if (mode == MODE_STATIC && !is_f32 && inv != nullptr)
    return launch<bf16, MODE_STATIC>(q, k, v, out, inv, B, N, H, D,
                                     batch_stride, row_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
