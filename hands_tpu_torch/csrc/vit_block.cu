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
// Under tensor parallelism (each rank a share of the heads and of the MLP's
// hidden columns) proj and MLP2 run as vit_gemm_f32, the same GEMM with an f32
// output and no epilogue: the ranks sum those partial products, then add the
// bias and the residual with the rounding points of the fused epilogue.
// The rounding points are those of block_math / _vit_block_kernel: every
// product is accumulated in f32 and rounded to bf16, the bias is added in
// bf16 after that rounding, attention logits are rounded to bf16 before an
// f32 softmax, p.v runs in f32, and the residual adds are bf16.
//
// What bounds it on this card: per ViT-H block the four GEMMs do 2*M*19.7M
// FLOPs over 39 MB of weights, i.e. M FLOPs per weight byte for M token rows.
// The H100's bf16 ridge is ~295 FLOPs/byte, so the weight stream from HBM
// bounds a block only below ~300 rows (under two 192-token crops); at the
// serving batches (8 images = 16 crops = 3072 rows, 0.122 ms of tensor-core
// time a block) and above, the GEMMs are bound by the tensor cores.
// Attention at N=192, D=80 is ~3% of the FLOPs.
// What the design does about it: vit_gemm is the bf16 form of the Hopper
// GEMM of gemm_sm90.cuh (a persistent grid of 128 x 128 tiles, TMA loads
// into a four-stage mbarrier ring, two MMA warpgroups on wgmma m64n128k16,
// epilogue warps that finish one tile while the next one's products run)
// with the four epilogues below, stored as bf16 pairs; the exact GELU's
// erfc comes from a table of its bf16 arguments. Attention runs on the
// tensor cores (mma.sync with ldmatrix operands, the logits and the softmax
// in registers, the f32 probabilities split into three bf16 parts); see
// attention_kernel.cuh. The LayerNorm is bound by its bytes (x in, y out)
// and is one warp per row: 16-byte loads into registers, shuffles only.

#include "attention_kernel.cuh"
#include "gemm_sm90.cuh"

namespace {

// bf16(erfcf(d)) for a bf16 value d, from a table of the values with 2^-16
// <= |d| < 16 (two signs, exponents 2^-16 .. 2^3, 128 mantissas each, as
// f32): erfcf of a bf16 value is all the exact GELU below ever evaluates,
// so the table gives its results bit for bit, at a shared-memory load
// instead of ~50 instructions. Outside the table the result is 1 (|d| <
// 2^-16: erfc(d) is within 2e-5 of 1), 0 (d >= 16) or 2 (d <= -16).
constexpr int ERFC_EXP_LO = 127 - 16;   // the exponent field of 2^-16
constexpr int ERFC_ENTRIES = 20 * 128;  // one sign
constexpr int ERFC_TABLE_BYTES = 2 * ERFC_ENTRIES * 4;  // 20 KB

__device__ __forceinline__ float erfc_bf16_table_entry(int k) {
  const uint32_t sign = k < ERFC_ENTRIES ? 0u : 1u;
  const uint32_t bits = (uint32_t)(ERFC_EXP_LO * 128 + k % ERFC_ENTRIES);
  return round_bf16(erfcf(__uint_as_float(sign << 31 | bits << 16)));
}

__device__ __forceinline__ float erfc_bf16(float d, const float* table) {
  const uint32_t bits = __float_as_uint(d);
  const uint32_t mag = bits & 0x7fffffffu, neg = bits >> 31;
  const int i = (int)(mag >> 16) - ERFC_EXP_LO * 128;
  const bool in = (unsigned)i < (unsigned)ERFC_ENTRIES;
  const float t = table[neg * ERFC_ENTRIES + (in ? i : 0)];
  const float outside =
      mag < (uint32_t)ERFC_EXP_LO << 23 ? 1.f : (neg ? 2.f : 0.f);
  return mag > 0x7f800000u ? d : (in ? t : outside);  // NaN stays NaN
}

// Exact GELU 0.5x * erfc(-x/sqrt2) with the bf16 rounding points of
// _gelu_mosaic (vit_block_pallas.py:60): each op rounds to bf16, and the
// 2^-0.5 constant is itself the bf16 value 0.70703125. x is bf16-exact;
// erfc through the table of erfc_bf16.
__device__ __forceinline__ float gelu_bf16(float x, const float* erfc_table) {
  const float half_x = round_bf16(0.5f * x);
  const float d = round_bf16(-x * 0.70703125f);
  const float e = erfc_bf16(d, erfc_table);
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
// One warp per row, WARP_ROWS rows a block (common.cuh's warp_row_stats).
// flax LayerNorm to its f32 rounding order: fast variance var = max(E[x^2] -
// E[x]^2, 0), mul = rsqrt(var + eps) * scale applied as one multiplier, y =
// (x - mu) * mul + bias, rounded to bf16. The row is read once, with 8-byte
// loads of 4 values, and held in registers (NV vectors a lane: 10 at C =
// 1280); its two sums are warp shuffles, with no shared memory and no
// barrier; scale and bias come as float4 and the output leaves as 8-byte
// stores. C is a multiple of 8 up to WARP_ROW_MAX_C.
template <int NV>
__global__ void __launch_bounds__(WARP_ROWS * 32) layernorm_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, bf16* __restrict__ out, int rows, int C,
    float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARP_ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int nvec = C / 4;
  float v[NV][4], mu, r;
  warp_row_stats<bf16, NV>(x + (size_t)row * C, C, eps, v, mu, r);
  uint2* outr = reinterpret_cast<uint2*>(out + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec) {
      const float4 m = reinterpret_cast<const float4*>(scale)[vi];
      const float4 b = reinterpret_cast<const float4*>(bias)[vi];
      const __nv_bfloat162 y0 = __floats2bfloat162_rn(
          ln_affine(v[i][0], mu, r, m.x, b.x),
          ln_affine(v[i][1], mu, r, m.y, b.y));
      const __nv_bfloat162 y1 = __floats2bfloat162_rn(
          ln_affine(v[i][2], mu, r, m.z, b.z),
          ln_affine(v[i][3], mu, r, m.w, b.w));
      outr[vi] = make_uint2(*reinterpret_cast<const uint32_t*>(&y0),
                            *reinterpret_cast<const uint32_t*>(&y1));
    }
  }
}

template <int NV>
int launch_layernorm(const void* x, const void* scale, const void* bias,
                     void* out, int rows, int C, float eps,
                     cudaStream_t stream) {
  layernorm_kernel<NV><<<(rows + WARP_ROWS - 1) / WARP_ROWS, WARP_ROWS * 32,
                         0, stream>>>((const bf16*)x, (const float*)scale,
                                   (const float*)bias, (bf16*)out, rows, C,
                                   eps);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ GEMM
// out[M, N] = epilogue(A[M, K] . W[N, K]^T), the bf16 form of gemm_sm90.cuh.
// Epilogue on the f32 accumulator: round to bf16 -> + bias (bf16 add) ->
// {nothing | exact GELU | tanh GELU | + residual (bf16)}.
enum {
  EPI_BIAS = 0,
  EPI_BIAS_GELU = 1,
  EPI_BIAS_RESIDUAL = 2,
  EPI_BIAS_GELU_TANH = 3
};

template <int EPI>
struct BlockEpilogue {
  const bf16* bias;      // (N,)
  const bf16* residual;  // (M, N), EPI_BIAS_RESIDUAL only
  bf16* out;             // (M, N)
  int N;
  const float* erfc_table;  // EPI_BIAS_GELU: in shared memory, see prepare

  // an inner tile's pairs start at even elements of 4-byte aligned rows
  __device__ __forceinline__ bool aligned_pairs() const { return N % 2 == 0; }

  static constexpr int SCRATCH_BYTES =
      EPI == EPI_BIAS_GELU ? ERFC_TABLE_BYTES : 0;

  // the exact GELU's erfc table, by the epilogue warps at the launch's start
  __device__ __forceinline__ void prepare(unsigned char* scratch, int thread,
                                          int threads) {
    float* table = reinterpret_cast<float*>(scratch);
    for (int k = thread; k < 2 * ERFC_ENTRIES; k += threads)
      table[k] = erfc_bf16_table_entry(k);
    erfc_table = table;
  }

  __device__ __forceinline__ float finish(float acc, float b, float r) const {
    const float x = round_bf16(round_bf16(acc) + b);
    if (EPI == EPI_BIAS_GELU) return gelu_bf16(x, erfc_table);
    if (EPI == EPI_BIAS_GELU_TANH) return gelu_tanh_bf16(x);
    if (EPI == EPI_BIAS_RESIDUAL) return r + x;
    return x;
  }

  template <bool EDGE>
  __device__ __forceinline__ void store2(float a0, float a1, int gm, int gn,
                                         bool two) const {
    const size_t idx = (size_t)gm * N + gn;
    const float2 b = pair_load<EDGE>(bias + gn, two);
    const float2 r = EPI == EPI_BIAS_RESIDUAL
                         ? pair_load<EDGE>(residual + idx, two)
                         : make_float2(0.f, 0.f);
    pair_store<EDGE>(out + idx, finish(a0, b.x, r.x), finish(a1, b.y, r.y),
                     two);
  }
};

// out[M, N] = A . W^T in f32, no bias: this rank's partial products of a
// row-parallel GEMM under tensor parallelism (the attention projection and
// the MLP's second GEMM on a rank's heads or hidden columns), which the ranks
// sum before the bias and the residual are added once, as the fused epilogue
// adds them: bf16(acc) + bias in bf16, then residual + y in bf16
struct PartialEpilogue {
  float* out;  // (M, N)
  int N;

  // an inner tile's pairs start at even elements of 8-byte aligned rows
  __device__ __forceinline__ bool aligned_pairs() const { return N % 2 == 0; }

  static constexpr int SCRATCH_BYTES = 0;  // no table
  __device__ __forceinline__ void prepare(unsigned char*, int, int) {}

  template <bool EDGE>
  __device__ __forceinline__ void store2(float a0, float a1, int gm, int gn,
                                         bool two) const {
    pair_store<EDGE>(out + (size_t)gm * N + gn, a0, a1, two);
  }
};

template <int EPI>
int block_gemm(const void* a, const void* w, const void* bias,
               const void* residual, void* out, int M, int N, int K,
               cudaStream_t stream) {
  const BlockEpilogue<EPI> ep{(const bf16*)bias, (const bf16*)residual,
                              (bf16*)out, N, nullptr};
  return launch_gemm((const bf16*)a, (const bf16*)w, ep, M, N, K, stream);
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
  if (rows < 1 || C < 8 || C > WARP_ROW_MAX_C || C % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return with_row_vectors(C, [&](auto nv) {
    return launch_layernorm<decltype(nv)::value>(x, scale, bias, out, rows,
                                                 C, eps, s);
  });
}

int vit_gemm(int device, const void* a, const void* w, const void* bias,
             const void* residual, void* out, int M, int N, int K,
             int epilogue, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_BIAS:
      return block_gemm<EPI_BIAS>(a, w, bias, residual, out, M, N, K, s);
    case EPI_BIAS_GELU:
      return block_gemm<EPI_BIAS_GELU>(a, w, bias, residual, out, M, N, K, s);
    case EPI_BIAS_RESIDUAL:
      return block_gemm<EPI_BIAS_RESIDUAL>(a, w, bias, residual, out, M, N, K,
                                           s);
    case EPI_BIAS_GELU_TANH:
      return block_gemm<EPI_BIAS_GELU_TANH>(a, w, bias, residual, out, M, N,
                                            K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out (M, N) f32 = A (M, K) . W (N, K)^T, no epilogue (PartialEpilogue)
int vit_gemm_f32(int device, const void* a, const void* w, void* out, int M,
                 int N, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PartialEpilogue ep{(float*)out, N};
  return launch_gemm((const bf16*)a, (const bf16*)w, ep, M, N, K,
                     (cudaStream_t)stream);
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
