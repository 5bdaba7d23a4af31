// Gaussian vertex-splat silhouette and its gradient for NVIDIA Hopper
// (sm_90a): the (B, P, V) pixel-vertex pair tensor never reaches device
// memory. Plain C interface, built with nvcc and loaded with ctypes by
// hands_tpu_torch/ops/rasterizer.py.
//
// Replaces: hands_tpu/ops/rasterizer_pallas.py:96 splat_silhouette_fused
// (custom_vjp; forward pl.pallas_call at :128, body _fwd_kernel at :39;
// backward pl.pallas_call at :174, body _bwd_kernel at :58).
//
//   forward   lm[b, p]   = sum_v log1p(-min(g, 1 - 1e-6)),
//             g          = exp(-max(d2, 0) / (2 sigma^2)),
//             mask[b, p] = 1 - exp(lm[b, p])
//   backward  dv[b, v]   = 2 sum_p C (v - pix_p),
//             C          = A_p g / (1 - g) / (2 sigma^2),
//             A_p        = -gmask[b, p] exp(lm[b, p])
//
// d2 is formed as the TPU kernel and the plain version form it,
// (|p|^2 + |v|^2) - 2 p.v with p.v = fma(p_y, v_y, p_x * v_x), every step
// rounded to f32 on its own (the intrinsics below are never contracted): at
// coordinates up to 112 the terms reach 25,000 and cancel to a few pixels
// squared, so any other rounding order moves d2 by ~1e-3 and the mask by
// more than the 2e-5 it is held to. expf and log1pf are the accurate
// library functions (no fast-math). The backward sums C (v - pix) directly,
// which spares it the second cancellation of the TPU kernel's
// 2 (v sum C - sum C pix).
//
// What bounds it on this card: operations. At B = 64, res = 112, V = 778
// there are 6.2e8 pairs, each with two special-function results (exp and
// log1p forward; exp and a division backward) against 3.6 MB (forward) or
// 7.2 MB (backward) of traffic. What this design does about it: the forward
// stages a sample's vertices (x, y, |v|^2) in shared memory once per block
// and gives each thread one pixel, so the inner loop reads broadcasts only;
// the backward gives each block 32 vertices times 8 pixel groups, stages
// A_p and the pixel coordinates of 256 pixels at a time in shared memory
// (one exp per pixel per block, not per pair), and reduces the 8 partial
// sums of a vertex in shared memory in f32. No vertex padding and no
// validity mask: those are tiling needs of the TPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_VT = 32;       // vertices per block
constexpr int BWD_PG = 8;        // pixel groups per block
constexpr int BWD_THREADS = BWD_VT * BWD_PG;
constexpr int BWD_CHUNK = 256;   // pixels staged at a time
static_assert(BWD_CHUNK == BWD_THREADS, "one staged pixel per thread");

__device__ __forceinline__ float clip_g() { return (float)(1.0 - 1e-6); }

// max((|p|^2 + |v|^2) - 2 p.v, 0), each step rounded on its own
__device__ __forceinline__ float dist2(float px, float py, float psq,
                                       float vx, float vy, float vsq) {
  const float cross = __fmaf_rn(py, vy, __fmul_rn(px, vx));
  return fmaxf(__fsub_rn(__fadd_rn(psq, vsq), __fmul_rn(2.0f, cross)), 0.0f);
}

__device__ __forceinline__ float sq_norm(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

__global__ void __launch_bounds__(FWD_THREADS)
splat_fwd_kernel(const float* __restrict__ v2d,  // (B, V, 2)
                 float* __restrict__ lm_out,     // (B, P)
                 float* __restrict__ mask_out,   // (B, P)
                 int V, int res, float two_s2) {
  extern __shared__ float sm[];  // x[V], y[V], |v|^2[V]
  float* sx = sm;
  float* sy = sm + V;
  float* sq = sm + 2 * V;
  const int b = blockIdx.y;
  const int P = res * res;
  const float* v = v2d + (size_t)b * V * 2;
  for (int i = threadIdx.x; i < V; i += FWD_THREADS) {
    const float x = v[2 * i], y = v[2 * i + 1];
    sx[i] = x;
    sy[i] = y;
    sq[i] = sq_norm(x, y);
  }
  __syncthreads();
  const int p = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (p >= P) return;
  const float px = (float)(p % res) + 0.5f, py = (float)(p / res) + 0.5f;
  const float psq = sq_norm(px, py);
  const float clip = clip_g();
  float lm = 0.0f;
  for (int i = 0; i < V; ++i) {
    const float d2 = dist2(px, py, psq, sx[i], sy[i], sq[i]);
    const float g = fminf(expf(__fdiv_rn(-d2, two_s2)), clip);
    lm += log1pf(-g);
  }
  lm_out[(size_t)b * P + p] = lm;
  mask_out[(size_t)b * P + p] = 1.0f - expf(lm);
}

__global__ void __launch_bounds__(BWD_THREADS)
splat_bwd_kernel(const float* __restrict__ v2d,    // (B, V, 2)
                 const float* __restrict__ lm,     // (B, P)
                 const float* __restrict__ gmask,  // (B, P)
                 float* __restrict__ dv,           // (B, V, 2)
                 int V, int res, float inv2s2) {
  __shared__ float sA[BWD_CHUNK], sPx[BWD_CHUNK], sPy[BWD_CHUNK],
      sPsq[BWD_CHUNK];
  __shared__ float red[2][BWD_PG][BWD_VT];
  const int b = blockIdx.y;
  const int P = res * res;
  const int vi = threadIdx.x % BWD_VT, pg = threadIdx.x / BWD_VT;
  const int vidx = blockIdx.x * BWD_VT + vi;
  const bool live = vidx < V;
  const float vx = live ? v2d[((size_t)b * V + vidx) * 2] : 0.0f;
  const float vy = live ? v2d[((size_t)b * V + vidx) * 2 + 1] : 0.0f;
  const float vsq = sq_norm(vx, vy);
  const float clip = clip_g();
  float gx = 0.0f, gy = 0.0f;
  for (int base = 0; base < P; base += BWD_CHUNK) {
    const int p = base + threadIdx.x;
    float a = 0.0f, px = 0.0f, py = 0.0f;
    if (p < P) {
      a = -gmask[(size_t)b * P + p] * expf(lm[(size_t)b * P + p]);
      px = (float)(p % res) + 0.5f;
      py = (float)(p / res) + 0.5f;
    }
    sA[threadIdx.x] = a;  // 0 past the last pixel: contributes nothing
    sPx[threadIdx.x] = px;
    sPy[threadIdx.x] = py;
    sPsq[threadIdx.x] = sq_norm(px, py);
    __syncthreads();
    for (int k = pg; k < BWD_CHUNK; k += BWD_PG) {
      const float qx = sPx[k], qy = sPy[k];
      const float d2 = dist2(qx, qy, sPsq[k], vx, vy, vsq);
      const float g = fminf(expf(-d2 * inv2s2), clip);
      const float c = sA[k] * g / (1.0f - g) * inv2s2;
      gx += c * (vx - qx);
      gy += c * (vy - qy);
    }
    __syncthreads();
  }
  red[0][pg][vi] = gx;
  red[1][pg][vi] = gy;
  __syncthreads();
  if (threadIdx.x < 2 * BWD_VT) {
    const int c = threadIdx.x / BWD_VT, u = threadIdx.x % BWD_VT;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < BWD_PG; ++k) s += red[c][k][u];
    const int vo = blockIdx.x * BWD_VT + u;
    if (vo < V) dv[((size_t)b * V + vo) * 2 + c] = 2.0f * s;
  }
}

}  // namespace

extern "C" {

// v2d (B, V, 2) -> lm, mask (B, res*res); contiguous f32. Returns the
// launch's cudaGetLastError() (0 = success); never synchronises.
int splat_fwd(int device, const void* v2d, void* lm, void* mask, int B, int V,
              int res, float sigma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || V <= 0 || res <= 0 || B > 65535 || !(sigma > 0.0f))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)V * 3 * sizeof(float);
  err = cudaFuncSetAttribute(splat_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int P = res * res;
  const dim3 grid((P + FWD_THREADS - 1) / FWD_THREADS, B);
  splat_fwd_kernel<<<grid, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)v2d, (float*)lm, (float*)mask, V, res,
      2.0f * sigma * sigma);
  return (int)cudaGetLastError();
}

// v2d (B, V, 2), lm and gmask (B, res*res) -> dv (B, V, 2); contiguous f32.
int splat_bwd(int device, const void* v2d, const void* lm, const void* gmask,
              void* dv, int B, int V, int res, float sigma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || V <= 0 || res <= 0 || B > 65535 || !(sigma > 0.0f))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + BWD_VT - 1) / BWD_VT, B);
  splat_bwd_kernel<<<grid, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)v2d, (const float*)lm, (const float*)gmask, (float*)dv, V,
      res, 1.0f / (2.0f * sigma * sigma));
  return (int)cudaGetLastError();
}

const char* splat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
