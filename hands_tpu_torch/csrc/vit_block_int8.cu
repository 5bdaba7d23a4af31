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
// twin bit for bit as long as the f32 dequantisation chain rounds where the
// twin rounds: acc * s_row * s_col + bias op by op (dynamic), acc * d_col +
// bias as one fused multiply-add (static, as XLA contracts it in the JAX
// kernels; common.cuh's dequant_static), and the f32 GELU steps. nvcc would
// contract any other multiply and add into one FMA, which rounds once
// instead of twice and flips an int8 step downstream, so this file is
// compiled with -fmad=false (explicit fmaf calls stay fused). A scale amax /
// 127 + 1e-12 is one fmaf(amax, 1/127, 1e-12): XLA turns the JAX block's
// division by a constant into a multiplication and contracts it with the
// addition, and the twins follow that.
//
// What bounds it on this card: per ViT-H block the four GEMMs do 2*M*19.7M
// integer operations over 19.7 MB of int8 weights, 2M operations per weight
// byte for M token rows; the int8 ridge of the H100 is ~590 operations per
// byte, so from ~300 rows on (3072 at the serving batch of 8 images: 0.061
// ms of tensor-core time a block) the GEMMs are bound by the tensor cores,
// and the LayerNorm/quantise passes by bytes (the dynamic block's f32
// residual stream doubles them against bf16).
// What the design does about it: the GEMM is the s8 form of the Hopper GEMM
// of gemm_sm90.cuh (a persistent grid of 128 x 128 tiles, TMA loads of
// 128-byte K tiles into a four-stage mbarrier ring, two MMA warpgroups on
// wgmma m64n128k32 with s32 accumulators, epilogue warps that finish one
// tile while the next one's products run); each of the seven dequantising
// epilogues below is a type, storing pairs of adjacent outputs. The
// LayerNorm + quantise pass is a warp per row: 16-byte loads, the row in
// registers, shuffles only, the int8 row leaving in 8-byte stores, so that
// its bytes (x in, q out, and the row scales) are all it waits on;
// quant_rows is still one thread block per row.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

// clip(round(y)) to [-127, 127] as an int: round half to even (F2I.RN, as
// rintf), then integer clamps
__device__ __forceinline__ int quant_i8(float y) {
  return min(max(__float2int_rn(y), -127), 127);
}

// quant_i8(y / s) of the IEEE quotient, given inv = RN(1 / s), for |y| <=
// 127.01 s (s = max|y| / 127 + 1e-12). t = RN(y * inv) is within 127.01 *
// (2^-23 + 2^-48) < 2^-16 of y / s, and RN(y / s) within 2^-18 of it (half
// an ulp below 128), so the two are less than 2^-15 apart: where t is
// farther than that from a half-integer, both round to the same integer;
// nearer (about 2^-14 of the values), the IEEE division decides.
__device__ __forceinline__ int quant_div(float y, float s, float inv) {
  const float t = y * inv;
  float k = rintf(t);
  if (fabsf(t - k) >= 0.5f - 0x1p-15f) k = y / s;
  return quant_i8(k);
}

// ---------------------------------------------------- LayerNorm + quantise
// One warp per row, WARP_ROWS rows a block, the row in registers (common.cuh's
// warp_row_stats: NV vectors of 4 values a lane, 8 bytes of bf16 or 16 of
// f32; 10 at C = 1280); every sum and the maximum are warp shuffles, with
// no shared memory and no barrier. flax LayerNorm to its f32 rounding order
// (fast variance max(E[x^2] - E[x]^2, 0); mul = rsqrt(var + eps) * scale as
// one multiplier; y = (x - mu) * mul + bias), then
//   DYNAMIC: s = max|y| / 127 + 1e-12, q = clip(round(y / s)) of the IEEE
//            quotient (quant_div below); writes q and s
//   static:  q = clip(round(y)) (scale and bias arrive pre-divided)
// scale and bias come as float4 loads; a vector's 4 int8 results leave as
// one 4-byte store. At the serving size (3072 rows) every row is in flight
// at once, so a warp's instructions between its loads and its stores add
// to the time: the quantisation is one F2I and two integer clamps, and the
// division runs only where it decides.
template <typename T, bool DYNAMIC, int NV>
__global__ void __launch_bounds__(WARP_ROWS * 32) ln_quant_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int8_t* __restrict__ q,
    float* __restrict__ s_out, int rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARP_ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int nvec = C / 4;
  float v[NV][4], mu, r;
  warp_row_stats<T, NV>(x + (size_t)row * C, C, eps, v, mu, r);
  float amax = 0.f;  // padding vectors stay out of it
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec) {
      const float4 m = reinterpret_cast<const float4*>(scale)[vi];
      const float4 b = reinterpret_cast<const float4*>(bias)[vi];
      v[i][0] = ln_affine(v[i][0], mu, r, m.x, b.x);
      v[i][1] = ln_affine(v[i][1], mu, r, m.y, b.y);
      v[i][2] = ln_affine(v[i][2], mu, r, m.z, b.z);
      v[i][3] = ln_affine(v[i][3], mu, r, m.w, b.w);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  float sc = 1.f, inv = 1.f;
  if (DYNAMIC) {
    sc = fmaf(warp_max(amax), INV127, 1e-12f);
    inv = 1.f / sc;
    if (lane == 0) s_out[row] = sc;
  }
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec) {
      uint32_t packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qv = DYNAMIC ? quant_div(v[i][j], sc, inv)
                               : quant_i8(v[i][j]);
        packed |= (uint32_t)(qv & 0xff) << (8 * j);
      }
      qr[vi] = packed;
    }
  }
}

// NV: the 4-value vectors a lane holds, C / 4 over 32 lanes
template <int NV, bool DYNAMIC>
int launch_ln_quant(const void* x, bool x_is_f32, const float* scale,
                    const float* bias, int8_t* q, float* s_out, int rows,
                    int C, float eps, cudaStream_t s) {
  const int blocks = (rows + WARP_ROWS - 1) / WARP_ROWS;
  if (x_is_f32)
    ln_quant_kernel<float, DYNAMIC, NV><<<blocks, WARP_ROWS * 32, 0, s>>>(
        (const float*)x, scale, bias, q, s_out, rows, C, eps);
  else
    ln_quant_kernel<bf16, DYNAMIC, NV><<<blocks, WARP_ROWS * 32, 0, s>>>(
        (const bf16*)x, scale, bias, q, s_out, rows, C, eps);
  return (int)cudaGetLastError();
}

template <bool DYNAMIC>
int dispatch_ln_quant(const void* x, bool x_is_f32, const float* scale,
                      const float* bias, int8_t* q, float* s_out, int rows,
                      int C, float eps, cudaStream_t s) {
  return with_row_vectors(C, [&](auto nv) {
    return launch_ln_quant<decltype(nv)::value, DYNAMIC>(
        x, x_is_f32, scale, bias, q, s_out, rows, C, eps, s);
  });
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
  EPI_STA_BF16 = 4,        // bf16(acc*d + b), acc*d + b one fma
  EPI_STA_RESID_BF16 = 5,  // bf16(res + bf16(acc*d + b)), res bf16
  EPI_STA_GELU_Q8 = 6      // int8 clip(round(gelu(acc*d + b) * inv_next))
};

// The epilogue of gemm_sm90.cuh's s8 loop: two adjacent outputs of one row,
// dequantised and finished in f32 in MODE's rounding order; FAST: the tanh
// GELU (else the exact one), a template argument so that an inner tile's
// epilogue has no branch.
template <int MODE, bool FAST = false>
struct Epilogue {
  const float* row_scale;  // (M,) dynamic only
  const float* col_scale;  // (N,)
  const float* bias;       // (N,)
  const void* residual;    // (M, N) f32 or bf16, residual modes only
  const float* inv_next;   // (N,) EPI_STA_GELU_Q8 only
  void* out;               // (M, N) bf16, f32 or int8
  int N;

  // an inner tile's pairs start at even elements of aligned rows
  __device__ __forceinline__ bool aligned_pairs() const { return N % 2 == 0; }

  static constexpr int SCRATCH_BYTES = 0;  // no table
  __device__ __forceinline__ void prepare(unsigned char*, int, int) {}

  __device__ __forceinline__ static float gelu(float h) {
    return FAST ? gelu_tanh_f32(h) : gelu_erfc_f32(h);
  }

  template <bool EDGE>
  __device__ __forceinline__ void store2(int a0, int a1, int gm, int gn,
                                         bool two) const {
    const size_t idx = (size_t)gm * N + gn;
    const float2 cs = pair_load<EDGE>(col_scale + gn, two);
    const float2 b = pair_load<EDGE>(bias + gn, two);
    bf16* out_bf16 = reinterpret_cast<bf16*>(out) + idx;
    float* out_f32 = reinterpret_cast<float*>(out) + idx;
    if (MODE <= EPI_DYN_GELU_F32) {
      const float sr = row_scale[gm];
      const float v0 = (float)a0 * sr * cs.x, v1 = (float)a1 * sr * cs.y;
      if (MODE == EPI_DYN_BF16) {
        pair_store<EDGE>(out_bf16, v0 + b.x, v1 + b.y, two);
      } else if (MODE == EPI_DYN_GELU_F32) {
        pair_store<EDGE>(out_f32, gelu(v0 + b.x), gelu(v1 + b.y), two);
      } else {
        const float2 r = pair_load<EDGE>(
            reinterpret_cast<const float*>(residual) + idx, two);
        const float o0 = (r.x + v0) + b.x, o1 = (r.y + v1) + b.y;
        if (MODE == EPI_DYN_RESID_F32)
          pair_store<EDGE>(out_f32, o0, o1, two);
        else
          pair_store<EDGE>(out_bf16, o0, o1, two);
      }
    } else {
      const float v0 = dequant_static(a0, cs.x, b.x);
      const float v1 = dequant_static(a1, cs.y, b.y);
      if (MODE == EPI_STA_BF16) {
        pair_store<EDGE>(out_bf16, v0, v1, two);
      } else if (MODE == EPI_STA_RESID_BF16) {
        const float2 r = pair_load<EDGE>(
            reinterpret_cast<const bf16*>(residual) + idx, two);
        pair_store<EDGE>(out_bf16, r.x + round_bf16(v0), r.y + round_bf16(v1),
                         two);
      } else {  // EPI_STA_GELU_Q8
        const float2 inv = pair_load<EDGE>(inv_next + gn, two);
        pair_store<EDGE>(reinterpret_cast<int8_t*>(out) + idx,
                         (int8_t)quant_clip(gelu(v0) * inv.x),
                         (int8_t)quant_clip(gelu(v1) * inv.y), two);
      }
    }
  }
};

template <int MODE, bool FAST = false>
int int8_gemm(const void* a, const void* w, const void* row_scale,
              const void* col_scale, const void* bias, const void* residual,
              const void* inv_next, void* out, int M, int N, int K,
              cudaStream_t stream) {
  const Epilogue<MODE, FAST> ep{
      (const float*)row_scale, (const float*)col_scale, (const float*)bias,
      residual, (const float*)inv_next, out, N};
  return launch_gemm((const int8_t*)a, (const int8_t*)w, ep, M, N, K, stream);
}

}  // namespace

// --------------------------------------------------------- C interface
// Pointers and the stream come from PyTorch as integers; every entry returns
// the launch's cudaGetLastError() (0 = success) and never synchronises.
extern "C" {

// s_out == NULL selects the static form (q = clip(round(LN'(x)))). C is a
// multiple of 8 up to WARP_ROW_MAX_C, as the bf16 LayerNorm's.
int i8_ln_quant(int device, const void* x, int x_is_f32, const void* scale,
                const void* bias, void* q, void* s_out, int rows, int C,
                float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || C < 8 || C > WARP_ROW_MAX_C || C % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const float* bi = (const float*)bias;
  int8_t* qo = (int8_t*)q;
  float* so = (float*)s_out;
  return so ? dispatch_ln_quant<true>(x, x_is_f32, sc, bi, qo, so, rows, C,
                                      eps, s)
            : dispatch_ln_quant<false>(x, x_is_f32, sc, bi, qo, so, rows, C,
                                       eps, s);
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
  cudaStream_t s = (cudaStream_t)stream;
#define I8_GEMM(MODE, FAST)                                                 \
  int8_gemm<MODE, FAST>(a, w, row_scale, col_scale, bias, residual, inv_next, \
                        out, M, N, K, s)
  switch (mode) {
    case EPI_DYN_BF16:
      return I8_GEMM(EPI_DYN_BF16, false);
    case EPI_DYN_RESID_F32:
      return I8_GEMM(EPI_DYN_RESID_F32, false);
    case EPI_DYN_RESID_BF16:
      return I8_GEMM(EPI_DYN_RESID_BF16, false);
    case EPI_DYN_GELU_F32:
      return fast_gelu ? I8_GEMM(EPI_DYN_GELU_F32, true)
                       : I8_GEMM(EPI_DYN_GELU_F32, false);
    case EPI_STA_BF16:
      return I8_GEMM(EPI_STA_BF16, false);
    case EPI_STA_RESID_BF16:
      return I8_GEMM(EPI_STA_RESID_BF16, false);
    case EPI_STA_GELU_Q8:
      return fast_gelu ? I8_GEMM(EPI_STA_GELU_Q8, true)
                       : I8_GEMM(EPI_STA_GELU_Q8, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef I8_GEMM
}

const char* i8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
