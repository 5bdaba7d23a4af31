// W8A8 ViT block for NVIDIA Hopper (sm_90a): LayerNorm + quantise, per-row
// quantise, and an int8 tensor-core GEMM with dequantising epilogues, behind
// a plain C interface (built with nvcc into a shared library and loaded with
// ctypes by hands_tpu_torch/ops/vit_block_int8.py). The attention of these
// blocks is in csrc/attention.cu. Build with -fmad=false: see below.
//
// Replaces: hands_tpu/ops/vit_block_pallas.py:501 vit_block_fused_int8
// (pl.pallas_call at :536, body _vit_block_int8_kernel at :211; per-token
// dynamic activation scales, f32 residual stream) and :627
// vit_block_fused_int8_static (pl.pallas_call at :658, body
// _vit_block_int8_static_kernel at :282; calibrated per-channel scales folded
// into the LayerNorm parameters and the weights, bf16 residual stream). Each
// keeps one whole block resident in TPU VMEM; a Hopper SM has 227 KB of
// shared memory against ~20 MB of int8 weights per ViT-H block, so a block
// becomes a sequence of launches:
//   dynamic (9): ln_quant, gemm(bf16), attention, quant_rows,
//                gemm(+f32 residual), ln_quant, gemm(GELU, f32), quant_rows,
//                gemm(+f32 residual, bf16 out)
//   static  (7): ln_quant, gemm(bf16), attention(int8 out),
//                gemm(+bf16 residual), ln_quant, gemm(GELU, int8 out),
//                gemm(+bf16 residual)
//
// Rounding. Quantisation rounds half to even (rintf), as jnp.round does. The
// int32 accumulations are exact in any order, so a GEMM agrees with its plain
// twin bit for bit as long as the f32 dequantisation chain is evaluated op by
// op: acc * s_row * s_col + bias (dynamic), acc * d_col + bias (static), and
// the f32 GELU steps. nvcc would contract a multiply and an add into one FMA,
// which rounds once instead of twice and flips an int8 step downstream, so
// this file is compiled with -fmad=false (explicit fmaf calls stay fused).
// A scale amax / 127 + 1e-12 is one fmaf(amax, 1/127, 1e-12): XLA turns the
// JAX block's division by a constant into a multiplication and contracts it
// with the addition, and the twins follow that.
//
// What bounds it on this card: per ViT-H block the four GEMMs do 2*M*19.7M
// integer operations over 19.7 MB of int8 weights, 2M operations per weight
// byte for M token rows; the int8 ridge of the H100 is ~590 operations per
// byte, so from ~300 rows on (3072 at the serving batch of 8 images) the
// GEMMs are bound by the tensor cores, and the LayerNorm/quantise passes by
// bytes (the dynamic block's f32 residual stream doubles them against bf16).
// What this simple design does about it: little yet. The GEMM runs
// mma.sync m16n8k32 s8 MMAs over 128x128x64 shared-memory tiles fed by
// cp.async through a 4-stage ring, with the epilogue applied to the
// accumulator registers; no TMA, no wgmma, no warp specialisation. The
// row passes are one thread block per row.

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

__device__ __forceinline__ float quant_clip(float v) {
  return fminf(fmaxf(rintf(v), -127.f), 127.f);
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

// ---------------------------------------------------- LayerNorm + quantise
// One block per row. flax LayerNorm to its f32 rounding order (fast variance
// max(E[x^2] - E[x]^2, 0); mul = rsqrt(var + eps) * scale as one multiplier;
// y = (x - mu) * mul + bias), then
//   DYNAMIC: s = max|y| / 127 + 1e-12, q = clip(round(y / s)); writes q and s
//   static:  q = clip(round(y)) (scale and bias arrive pre-divided)
template <typename T, bool DYNAMIC>
__global__ void __launch_bounds__(ROW_THREADS) ln_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int8_t* __restrict__ q,
    float* __restrict__ s_out, int C, float eps) {
  extern __shared__ float ybuf[];  // C values of this row
  __shared__ float red[ROW_THREADS / 32];
  const T* xr = x + (size_t)blockIdx.x * C;
  int8_t* qr = q + (size_t)blockIdx.x * C;

  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x; c < C; c += ROW_THREADS) {
    const float v = to_float(xr[c]);
    ybuf[c] = v;
    s += v;
    ss += v * v;
  }
  s = block_reduce<false>(s, red);
  ss = block_reduce<false>(ss, red);
  const float mu = s / (float)C;
  const float var = fmaxf(ss / (float)C - mu * mu, 0.f);
  const float r = rsqrtf(var + eps);
  float amax = 0.f;
  for (int c = threadIdx.x; c < C; c += ROW_THREADS) {
    const float y = (ybuf[c] - mu) * (r * scale[c]) + bias[c];
    ybuf[c] = y;
    amax = fmaxf(amax, fabsf(y));
  }
  float sc = 1.f;
  if (DYNAMIC) {
    amax = block_reduce<true>(amax, red);
    sc = fmaf(amax, INV127, 1e-12f);
    if (threadIdx.x == 0) s_out[blockIdx.x] = sc;
  }
  for (int c = threadIdx.x; c < C; c += ROW_THREADS)
    qr[c] = (int8_t)quant_clip(DYNAMIC ? ybuf[c] / sc : ybuf[c]);
}

// ------------------------------------------------------- per-row quantise
// _quant_rows_f32 on a finished (R, K) tensor: s = max|row| / 127 + 1e-12,
// q = clip(round(a / s)). One block per row.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) quant_rows_kernel(
    const T* __restrict__ a, int8_t* __restrict__ q, float* __restrict__ s_out,
    int K) {
  __shared__ float red[ROW_THREADS / 32];
  const T* ar = a + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int c = threadIdx.x; c < K; c += ROW_THREADS)
    amax = fmaxf(amax, fabsf(to_float(ar[c])));
  amax = block_reduce<true>(amax, red);
  const float sc = fmaf(amax, INV127, 1e-12f);
  if (threadIdx.x == 0) s_out[blockIdx.x] = sc;
  for (int c = threadIdx.x; c < K; c += ROW_THREADS)
    qr[c] = (int8_t)quant_clip(to_float(ar[c]) / sc);
}

// -------------------------------------------------------------- int8 GEMM
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

// D (16x8, s32) += A (16x32, s8, row) . B (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum {
  EPI_DYN_BF16 = 0,        // bf16(acc*sr*sc + b)
  EPI_DYN_RESID_F32 = 1,   // f32 (res + acc*sr*sc) + b, res f32
  EPI_DYN_RESID_BF16 = 2,  // the same, rounded to bf16
  EPI_DYN_GELU_F32 = 3,    // f32 gelu(acc*sr*sc + b)
  EPI_STA_BF16 = 4,        // bf16(acc*d + b)
  EPI_STA_RESID_BF16 = 5,  // bf16(res + bf16(acc*d + b)), res bf16
  EPI_STA_GELU_Q8 = 6      // int8 clip(round(gelu(acc*d + b) * inv_next))
};

struct Epilogue {
  const float* row_scale;  // (M,) dynamic only
  const float* col_scale;  // (N,)
  const float* bias;       // (N,)
  const void* residual;    // (M, N) f32 or bf16, residual modes only
  const float* inv_next;   // (N,) EPI_STA_GELU_Q8 only
  void* out;               // (M, N) bf16, f32 or int8
  int mode;
  int fast_gelu;
};

__device__ __forceinline__ void epilogue_store(const Epilogue& e, int acc,
                                               int gm, int gn, size_t idx) {
  float v = (float)acc;
  if (e.mode <= EPI_DYN_GELU_F32) {
    v = v * e.row_scale[gm];
    v = v * e.col_scale[gn];
  } else {
    v = v * e.col_scale[gn] + e.bias[gn];
  }
  switch (e.mode) {
    case EPI_DYN_BF16:
      reinterpret_cast<bf16*>(e.out)[idx] =
          __float2bfloat16_rn(v + e.bias[gn]);
      break;
    case EPI_DYN_RESID_F32:
      reinterpret_cast<float*>(e.out)[idx] =
          (reinterpret_cast<const float*>(e.residual)[idx] + v) + e.bias[gn];
      break;
    case EPI_DYN_RESID_BF16:
      reinterpret_cast<bf16*>(e.out)[idx] = __float2bfloat16_rn(
          (reinterpret_cast<const float*>(e.residual)[idx] + v) + e.bias[gn]);
      break;
    case EPI_DYN_GELU_F32: {
      const float h = v + e.bias[gn];
      reinterpret_cast<float*>(e.out)[idx] =
          e.fast_gelu ? gelu_tanh_f32(h) : gelu_erfc_f32(h);
      break;
    }
    case EPI_STA_BF16:
      reinterpret_cast<bf16*>(e.out)[idx] = __float2bfloat16_rn(v);
      break;
    case EPI_STA_RESID_BF16:
      reinterpret_cast<bf16*>(e.out)[idx] = __float2bfloat16_rn(
          to_float(reinterpret_cast<const bf16*>(e.residual)[idx]) +
          round_bf16(v));
      break;
    default: {  // EPI_STA_GELU_Q8
      const float h = e.fast_gelu ? gelu_tanh_f32(v) : gelu_erfc_f32(v);
      reinterpret_cast<int8_t*>(e.out)[idx] =
          (int8_t)quant_clip(h * e.inv_next[gn]);
    }
  }
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T): A row-major int8, W int8 in
// nn.Linear's (out, in) layout, int32 accumulation. Requires K % 16 == 0 and
// 16-byte aligned A and W (the wrapper checks); M and N edges are masked
// (zero-filled copies, guarded stores).
constexpr int BM = 128, BN = 128, BK = 64, SKEW = 16, STAGES = 4;
constexpr int LDS = BK + SKEW;     // 80-byte rows: 16-byte chunks stay
                                   // aligned, fragment loads hit 32 banks
constexpr int GEMM_THREADS = 256;  // 8 warps as 2 (M) x 4 (N), 64x32 each
constexpr size_t GEMM_SMEM = (size_t)STAGES * (BM + BN) * LDS;  // 81,920 B

__global__ void __launch_bounds__(GEMM_THREADS) gemm_i8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W, Epilogue ep,
    int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  int8_t* As = reinterpret_cast<int8_t*>(gemm_smem);  // STAGES x BM x LDS
  int8_t* Bs = As + STAGES * BM * LDS;                // STAGES x BN x LDS

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // a stage is 128 rows x 4 chunks of 16 int8 per operand: 2 chunks of A
  // and 2 of W per thread
  auto load_stage = [&](int stage, int k0) {
    int8_t* as = As + stage * BM * LDS;
    int8_t* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const bool a_ok = m0 + r < M && gk < K;
      const bool b_ok = n0 + r < N && gk < K;
      cp_async16(as + r * LDS + kc,
                 a_ok ? A + (size_t)(m0 + r) * K + gk : A, a_ok);
      cp_async16(bs + r * LDS + kc,
                 b_ok ? W + (size_t)(n0 + r) * K + gk : W, b_ok);
    }
  };

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();  // one group per stage, empty ones included
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's landed; everyone is done with tile kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk * BK);  // into tile kt-1's slot
    cp_async_commit();
    const int8_t* as = As + (kt % STAGES) * BM * LDS;
    const int8_t* bs = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* row = as + (warp_m * 64 + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(row);
        af[i][1] = *reinterpret_cast<const uint32_t*>(row + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(row + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(row + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* col = bs + (warp_n * 32 + j * 8 + g) * LDS + kk + t * 4;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(col);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();  // only empty groups remain; drain before exit

  // epilogue straight from the accumulator registers: a thread holds rows
  // g and g + 8 and columns 2t, 2t + 1 of each 16x8 tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + warp_m * 64 + i * 16 + g + (r >> 1) * 8;
        const int gn = n0 + warp_n * 32 + j * 8 + t * 2 + (r & 1);
        if (gm < M && gn < N)
          epilogue_store(ep, acc[i][j][r], gm, gn, (size_t)gm * N + gn);
      }
    }
  }
}

}  // namespace

// --------------------------------------------------------- C interface
// Pointers and the stream come from PyTorch as integers; every entry returns
// the launch's cudaGetLastError() (0 = success) and never synchronises.
extern "C" {

// s_out == NULL selects the static form (q = clip(round(LN'(x)))).
int i8_ln_quant(int device, const void* x, int x_is_f32, const void* scale,
                const void* bias, void* q, void* s_out, int rows, int C,
                float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)C * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  int8_t* qo = (int8_t*)q;
  float* so = (float*)s_out;
  if (x_is_f32 && so)
    ln_quant_kernel<float, true><<<rows, ROW_THREADS, smem, s>>>(
        (const float*)x, sc, bi, qo, so, C, eps);
  else if (x_is_f32)
    ln_quant_kernel<float, false><<<rows, ROW_THREADS, smem, s>>>(
        (const float*)x, sc, bi, qo, so, C, eps);
  else if (so)
    ln_quant_kernel<bf16, true><<<rows, ROW_THREADS, smem, s>>>(
        (const bf16*)x, sc, bi, qo, so, C, eps);
  else
    ln_quant_kernel<bf16, false><<<rows, ROW_THREADS, smem, s>>>(
        (const bf16*)x, sc, bi, qo, so, C, eps);
  return (int)cudaGetLastError();
}

int i8_quant_rows(int device, const void* a, int a_is_f32, void* q,
                  void* s_out, int rows, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (a_is_f32)
    quant_rows_kernel<float><<<rows, ROW_THREADS, 0, s>>>(
        (const float*)a, (int8_t*)q, (float*)s_out, K);
  else
    quant_rows_kernel<bf16><<<rows, ROW_THREADS, 0, s>>>(
        (const bf16*)a, (int8_t*)q, (float*)s_out, K);
  return (int)cudaGetLastError();
}

int i8_gemm(int device, const void* a, const void* w, const void* row_scale,
            const void* col_scale, const void* bias, const void* residual,
            const void* inv_next, void* out, int M, int N, int K, int mode,
            int fast_gelu, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < EPI_DYN_BF16 || mode > EPI_STA_GELU_Q8)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gemm_i8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  Epilogue ep;
  ep.row_scale = (const float*)row_scale;
  ep.col_scale = (const float*)col_scale;
  ep.bias = (const float*)bias;
  ep.residual = residual;
  ep.inv_next = (const float*)inv_next;
  ep.out = out;
  ep.mode = mode;
  ep.fast_gelu = fast_gelu;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, ep, M, N, K);
  return (int)cudaGetLastError();
}

const char* i8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
