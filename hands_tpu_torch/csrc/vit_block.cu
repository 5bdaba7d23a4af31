// Fused ViT block for NVIDIA Hopper (sm_90a), bf16, as three hand-written
// kernels behind a plain C interface (built with nvcc into a shared library
// and loaded with ctypes by hands_tpu_torch/ops/vit_block.py).
//
// Replaces: hands_tpu/ops/vit_block_pallas.py:382 vit_block_fused
// (pl.pallas_call at :414, kernel body _vit_block_kernel at :138), which keeps
// one whole pre-LN block resident in TPU VMEM. A Hopper SM has 227 KB of
// shared memory against ~39 MB of bf16 weights per ViT-H block, so the block
// is split into three kernels, launched seven times per block:
//   vit_layernorm  x2   LN1, LN2: f32 statistics (flax fast variance), bf16 out
//   vit_gemm       x4   qkv, proj(+residual), MLP1(+GELU, exact or tanh),
//                       MLP2(+residual)
//   vit_attention  x1   attention_kernel.cuh's tensor-core kernel, MODE_BLOCK
// The rounding points are those of block_math / _vit_block_kernel: every
// product is accumulated in f32 and rounded to bf16, the bias is added in
// bf16 after that rounding, attention logits are rounded to bf16 before an
// f32 softmax, p.v runs in f32, and the residual adds are bf16.
//
// What bounds it on this card: per ViT-H block the four GEMMs do 2*M*19.7M
// FLOPs over 39 MB of weights, i.e. M FLOPs per weight byte for M token rows.
// The H100's bf16 ridge is ~295 FLOPs/byte, so the weight stream from HBM
// bounds a block only below ~300 rows (under two 192-token crops); at the
// serving batches (8 images = 16 crops = 3072 rows) and above, the GEMMs are
// compute-bound on the tensor cores. Attention at N=192, D=80 is ~3% of the
// FLOPs.
// What this simple design does about it: little yet for the GEMM, a plain
// nvcuda::wmma 16x16x16 bf16 kernel over 128x128x32 shared-memory tiles,
// fed by cp.async through a 4-stage ring so that global-memory latency
// hides behind three tiles of MMAs; no TMA, no wgmma, no warp
// specialisation, no persistent scheduling. Its epilogue finishes 8
// adjacent outputs per lane with 16-byte loads and stores. Attention runs
// on the tensor cores (mma.sync with ldmatrix operands, the logits and the
// softmax in registers, the f32 probabilities split into three bf16 parts);
// see attention_kernel.cuh.

#include <mma.h>

#include "attention_kernel.cuh"

using namespace nvcuda;

namespace {

// Exact GELU 0.5x * erfc(-x/sqrt2) with the bf16 rounding points of
// _gelu_mosaic (vit_block_pallas.py:60): each op rounds to bf16, and the
// 2^-0.5 constant is itself the bf16 value 0.70703125. x is bf16-exact.
__device__ __forceinline__ float gelu_bf16(float x) {
  const float half_x = round_bf16(0.5f * x);
  const float d = round_bf16(-x * 0.70703125f);
  const float e = round_bf16(erfcf(d));
  return round_bf16(half_x * e);
}

// tanh-approximate GELU x * 0.5 * (1 + tanh(c * (x + k x^3))) with the bf16
// rounding points of jax.nn.gelu(approximate=True) on a bf16 array (the fast
// form of _gelu_mosaic): each op rounds to bf16, and the constants are the
// bf16 values of sqrt(2/pi) (0.796875) and 0.044715 (0.044677734375).
__device__ __forceinline__ float gelu_tanh_bf16(float x) {
  const float x2 = round_bf16(x * x);
  const float x3 = round_bf16(x * x2);
  const float kx3 = round_bf16(0.044677734375f * x3);
  const float u = round_bf16(x + kx3);
  const float w = round_bf16(0.796875f * u);
  const float t = round_bf16(tanhf(w));
  const float a = round_bf16(1.0f + t);
  const float cdf = round_bf16(0.5f * a);
  return round_bf16(x * cdf);
}

// ------------------------------------------------------------- LayerNorm
// One block per row. flax LayerNorm to its f32 rounding order: fast variance
// var = max(E[x^2] - E[x]^2, 0), mul = rsqrt(var + eps) * scale applied as
// one multiplier, y = (x - mu) * mul + bias, rounded to bf16.
constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS) layernorm_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, bf16* __restrict__ out, int C,
    float eps) {
  __shared__ float red_s[LN_THREADS / 32];
  __shared__ float red_ss[LN_THREADS / 32];
  const bf16* xr = x + (size_t)blockIdx.x * C;
  bf16* outr = out + (size_t)blockIdx.x * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x; c < C; c += LN_THREADS) {
    const float v = __bfloat162float(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red_s[warp] = s;
    red_ss[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < LN_THREADS / 32 ? red_s[lane] : 0.f;
    ss = lane < LN_THREADS / 32 ? red_ss[lane] : 0.f;
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      red_s[0] = s;
      red_ss[0] = ss;
    }
  }
  __syncthreads();
  const float mu = red_s[0] / (float)C;
  const float var = fmaxf(red_ss[0] / (float)C - mu * mu, 0.f);
  const float r = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += LN_THREADS) {
    const float v = __bfloat162float(xr[c]);
    outr[c] = __float2bfloat16_rn((v - mu) * (r * scale[c]) + bias[c]);
  }
}

// ------------------------------------------------------------------ GEMM
// out[M, N] = epilogue(A[M, K] . W[N, K]^T): A row-major, W in nn.Linear's
// (out, in) layout, f32 accumulation. Epilogue on the accumulator:
// round to bf16 -> + bias (bf16 add) -> {nothing | exact GELU | tanh GELU |
// + residual (bf16)}.
// Requires K % 8 == 0 and 16-byte aligned A and W (checked by the wrapper);
// M and N edges are masked (zero-filled copies, guarded stores); bias,
// residual and out must be 16-byte aligned too (the wrapper checks).
constexpr int BM = 128, BN = 128, BK = 32, SKEW = 8, STAGES = 4;
constexpr int LDS = BK + SKEW;  // 80-byte rows: 16-byte chunks stay aligned
constexpr int GEMM_THREADS = 256;  // 8 warps as 2 (M) x 4 (N), 64x32 each
constexpr size_t GEMM_SMEM =
    (size_t)STAGES * (BM + BN) * LDS * sizeof(bf16) +
    (size_t)(GEMM_THREADS / 32) * 16 * 16 * sizeof(float);  // 90,112 B
enum {
  EPI_BIAS = 0,
  EPI_BIAS_GELU = 1,
  EPI_BIAS_RESIDUAL = 2,
  EPI_BIAS_GELU_TANH = 3
};

__global__ void __launch_bounds__(GEMM_THREADS) gemm_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W,
    const bf16* __restrict__ bias, const bf16* __restrict__ residual,
    bf16* __restrict__ out, int M, int N, int K, int epilogue) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);  // STAGES x BM x LDS
  bf16* Bs = As + STAGES * BM * LDS;              // STAGES x BN x LDS
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * BN * LDS);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // a stage is 128 rows x 4 chunks of 8 bf16 (16 bytes) per operand:
  // 2 chunks of A and 2 of W per thread
  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * BM * LDS;
    bf16* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
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
    const bf16* as = As + (kt % STAGES) * BM * LDS;
    const bf16* bs = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (warp_m * 64 + i * 16) * LDS + kk,
                               LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs + (warp_n * 32 + j * 16) * LDS + kk,
                               LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();  // only empty groups remain; drain before exit

  // epilogue: stage one 16x16 accumulator at a time in the warp's own
  // shared-memory slot; each lane then finishes 8 adjacent outputs of it
  // (row lane/2, columns (lane%2)*8 ..+8) through the rounding chain
  float* stage = Cs + warp * 16 * 16;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const bool vec_ok = (N % 8) == 0;  // 16-byte aligned rows of out/residual
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + warp_m * 64 + i * 16 + r;
      const int gn = n0 + warp_n * 32 + j * 16 + c0;
      if (gm < M) {
        float v[8];
        const float4 lo = *reinterpret_cast<const float4*>(stage + r * 16 + c0);
        const float4 hi =
            *reinterpret_cast<const float4*>(stage + r * 16 + c0 + 4);
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
        const size_t row = (size_t)gm * N;
        if (vec_ok && gn + 8 <= N) {
          const uint4 braw = *reinterpret_cast<const uint4*>(bias + gn);
          const bf16* b8 = reinterpret_cast<const bf16*>(&braw);
          uint4 rraw = make_uint4(0u, 0u, 0u, 0u);
          if (epilogue == EPI_BIAS_RESIDUAL)
            rraw = *reinterpret_cast<const uint4*>(residual + row + gn);
          const bf16* r8 = reinterpret_cast<const bf16*>(&rraw);
          uint4 oraw;
          bf16* o8 = reinterpret_cast<bf16*>(&oraw);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float x = round_bf16(v[e]);
            x = round_bf16(x + __bfloat162float(b8[e]));
            if (epilogue == EPI_BIAS_GELU) {
              x = gelu_bf16(x);
            } else if (epilogue == EPI_BIAS_GELU_TANH) {
              x = gelu_tanh_bf16(x);
            } else if (epilogue == EPI_BIAS_RESIDUAL) {
              x = __bfloat162float(r8[e]) + x;
            }
            o8[e] = __float2bfloat16_rn(x);
          }
          *reinterpret_cast<uint4*>(out + row + gn) = oraw;
        } else {
          for (int e = 0; e < 8 && gn + e < N; ++e) {
            float x = round_bf16(v[e]);
            x = round_bf16(x + __bfloat162float(bias[gn + e]));
            if (epilogue == EPI_BIAS_GELU) {
              x = gelu_bf16(x);
            } else if (epilogue == EPI_BIAS_GELU_TANH) {
              x = gelu_tanh_bf16(x);
            } else if (epilogue == EPI_BIAS_RESIDUAL) {
              x = __bfloat162float(residual[row + gn + e]) + x;
            }
            out[row + gn + e] = __float2bfloat16_rn(x);
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// --------------------------------------------------------- C interface
// Pointers and the stream come from PyTorch as integers; every entry returns
// the launch's cudaGetLastError() (0 = success) and never synchronises.
extern "C" {

int vit_layernorm(int device, const void* x, const void* scale,
                  const void* bias, void* out, int rows, int C, float eps,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  layernorm_kernel<<<rows, LN_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)out, C,
      eps);
  return (int)cudaGetLastError();
}

int vit_gemm(int device, const void* a, const void* w, const void* bias,
             const void* residual, void* out, int M, int N, int K,
             int epilogue, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gemm_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias,
      (const bf16*)residual, (bf16*)out, M, N, K, epilogue);
  return (int)cudaGetLastError();
}

// qkv (B*N, 3C) with column s*C + h*D + d (s = q, k, v) -> out (B*N, C)
int vit_attention(int device, const void* qkv, void* out, int B, int N,
                  int H, int D, float q_scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long C = (long long)H * D;
  const bf16* q = (const bf16*)qkv;
  return launch<MODE_BLOCK>(q, q + C, q + 2 * C, out, nullptr, B, N, H, D,
                            N * 3 * C, 3 * C, q_scale, (cudaStream_t)stream);
}

const char* vit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
