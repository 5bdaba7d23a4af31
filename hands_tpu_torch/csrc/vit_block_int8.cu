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

#include "common.cuh"
#include "gemm_i8.cuh"

namespace {

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

  __device__ __forceinline__ void store(int acc, int gm, int gn,
                                        size_t idx) const {
    float v = (float)acc;
    if (mode <= EPI_DYN_GELU_F32) {
      v = v * row_scale[gm];
      v = v * col_scale[gn];
    } else {
      v = v * col_scale[gn] + bias[gn];
    }
    switch (mode) {
      case EPI_DYN_BF16:
        reinterpret_cast<bf16*>(out)[idx] =
            __float2bfloat16_rn(v + bias[gn]);
        break;
      case EPI_DYN_RESID_F32:
        reinterpret_cast<float*>(out)[idx] =
            (reinterpret_cast<const float*>(residual)[idx] + v) + bias[gn];
        break;
      case EPI_DYN_RESID_BF16:
        reinterpret_cast<bf16*>(out)[idx] = __float2bfloat16_rn(
            (reinterpret_cast<const float*>(residual)[idx] + v) + bias[gn]);
        break;
      case EPI_DYN_GELU_F32: {
        const float h = v + bias[gn];
        reinterpret_cast<float*>(out)[idx] =
            fast_gelu ? gelu_tanh_f32(h) : gelu_erfc_f32(h);
        break;
      }
      case EPI_STA_BF16:
        reinterpret_cast<bf16*>(out)[idx] = __float2bfloat16_rn(v);
        break;
      case EPI_STA_RESID_BF16:
        reinterpret_cast<bf16*>(out)[idx] = __float2bfloat16_rn(
            to_float(reinterpret_cast<const bf16*>(residual)[idx]) +
            round_bf16(v));
        break;
      default: {  // EPI_STA_GELU_Q8
        const float h = fast_gelu ? gelu_tanh_f32(v) : gelu_erfc_f32(v);
        reinterpret_cast<int8_t*>(out)[idx] =
            (int8_t)quant_clip(h * inv_next[gn]);
      }
    }
  }
};


// The GEMM of both blocks: the main loop of gemm_i8.cuh with the epilogue
// chosen at run time by ep.mode.
__global__ void __launch_bounds__(GEMM_THREADS) gemm_i8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W, Epilogue ep,
    int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  gemm_i8_tile(A, W, ep, M, N, K, gemm_smem);
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
