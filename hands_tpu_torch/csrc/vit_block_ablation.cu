// Knock-out variants of the static W8A8 ViT block for NVIDIA Hopper (sm_90a):
// the kernels that hands_tpu_torch/ops/vit_block_ablation.py launches in
// place of one or more of the static block's seven, so that the block's time
// can be attributed piece by piece. Plain C interface, built with nvcc and
// loaded with ctypes. Build with -fmad=false, as vit_block_int8.cu: after
// the dequantisation (one fma, common.cuh) the f32 chains round op by op.
//
// Replaces: scripts/vith_int8_ablation.py:178 run_variant (pl.pallas_call at
// :194, body _ablation_kernel at :48). The TPU kernel is the static block's
// body with a `mode` switch traced into it; here the block is a sequence of
// launches, so a mode swaps launches:
//   no_ln       abl_ln (NO_LN): x * s + b, round, clip; no mean, no variance
//   no_quant    abl_ln (CAST), abl_attention (MODE_STATIC_CAST), abl_gemm
//               (EPI_GELU_CAST): the bare cast instead of round and clip
//   no_gelu     abl_gemm (EPI_IDENT_Q8)
//   no_softmax  abl_attention (MODE_NO_SOFTMAX)
//   no_attn     abl_qslice_quant: the q third of qkv times inv_proj, quantised
//   attn_i8     abl_attention_i8 (attention_kernel.cuh's int8 route,
//               MODE_I8): q, k, v quantised with fixed scales, both products
//               on the int8 tensor cores with int32 sums, f32 softmax
//   attn_merged abl_heads_split (qkv -> head-major (3, B*H, N, D)),
//               abl_attention (MODE_STATIC_F32 on contiguous heads),
//               abl_heads_merge_quant (f32 (B*H, N, D) -> int8 (B, N, C))
//   mm_only     abl_cast_rows, abl_gemm (EPI_CAST) three times, then the
//               serving GEMM's plain bf16 epilogue
// The main loop of the GEMM (gemm_sm90.cuh, its s8 form) and the attention
// kernel (attention_kernel.cuh) are the serving kernels' own code,
// instantiated here with other compile-time epilogues and modes.
//
// What bounds them on this card: the row and relayout passes move a few
// bytes per element and do a handful of operations on each, so they are
// bound by bytes; the GEMM variants by the int8 tensor cores as the serving
// GEMM; the int8 attention by its bytes too (bf16 q, k, v in, int8 out:
// 4*N*N*D integer operations a head are 0.024 ms of int8 tensor-core time
// at 256 crops against 0.13 ms of bytes), as long as the softmax between
// its two products keeps up. What the design does about it: the LayerNorm
// knock-outs are ln_quant's layout (a warp per row, the row in registers,
// common.cuh's warp_row_stats, 4 int8 results a 4-byte store); heads_split
// and heads_merge_quant are a warp per token row moving whole head segments
// in 16-byte vectors (4-byte ones when D or the pointers do not allow 16),
// one division per row; cast_rows and qslice_quant move vectors of 8 bf16
// (a 16-byte load, its 8 int8 results one 8-byte store; 2 or 1 value where
// the pointers or C do not allow 8), cast_rows as a grid of the blocks the
// card holds at once striding over the vectors, qslice_quant as a warp per
// token row with no division; the attention kernels' MMA geometry (see
// attention_kernel.cuh) for every attention mode, int8 included.

#include "attention_kernel.cuh"
#include "gemm_sm90.cuh"

namespace {

// ------------------------------------------------- LayerNorm knock-outs
// The static block's ln_quant (vit_block_int8.cu) with one piece knocked
// out, on its layout: one warp per bf16 row, WARP_ROWS rows a block, the row
// in registers as NV vectors of 4 values a lane (8-byte loads), shuffles
// only, no shared memory and no barrier. NO_LN (ln_affine_quant): y = x * s
// + b, each step rounded, no statistics, then round and clip; else
// (ln_cast) flax's LayerNorm (warp_row_stats: the twin's sum order and E[.]
// = sum * RN(1/C); ln_affine), then the bare cast. A vector's 4 int8
// results leave as one 4-byte store.
template <bool NO_LN, int NV>
__global__ void __launch_bounds__(WARP_ROWS * 32) ln_ablation_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, int8_t* __restrict__ q, int rows, int C,
    float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARP_ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int nvec = C / 4;
  const bf16* xr = x + (size_t)row * C;
  float v[NV][4], mu = 0.f, r = 0.f;
  if constexpr (NO_LN) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) load4(xr + (size_t)(i * 32 + lane) * 4, v[i]);
  } else {
    warp_row_stats<bf16, NV>(xr, C, eps, v, mu, r);
  }
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec) {
      const float4 m4 = reinterpret_cast<const float4*>(scale)[vi];
      const float4 b4 = reinterpret_cast<const float4*>(bias)[vi];
      const float m[4] = {m4.x, m4.y, m4.z, m4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      uint32_t packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = NO_LN ? __fadd_rn(__fmul_rn(v[i][j], m[j]), b[j])
                              : ln_affine(v[i][j], mu, r, m[j], b[j]);
        const int qv = NO_LN ? (int)quant_clip(y) : (int)cast_i8(y);
        packed |= (uint32_t)(qv & 0xff) << (8 * j);
      }
      qr[vi] = packed;
    }
  }
}

template <bool NO_LN>
int launch_ln_ablation(const void* x, const void* scale, const void* bias,
                       void* q, int rows, int C, float eps, cudaStream_t s) {
  const int blocks = (rows + WARP_ROWS - 1) / WARP_ROWS;
  return with_row_vectors(C, [&](auto nv) {
    ln_ablation_kernel<NO_LN, decltype(nv)::value>
        <<<blocks, WARP_ROWS * 32, 0, s>>>(
            (const bf16*)x, (const float*)scale, (const float*)bias,
            (int8_t*)q, rows, C, eps);
    return (int)cudaGetLastError();
  });
}

// ------------------------------------------------ bf16 -> int8 passes
// cast_rows and qslice_quant read bf16 and write int8, 3 bytes a value and a
// handful of operations: they are bound by bytes. Both move vectors of W
// bf16 values, W = 8 (a 16-byte load; its 8 int8 results leave as one
// 8-byte store), 2 (a 4-byte load, a 2-byte store) or 1, the widest that the
// pointers and the widths allow; the caller picks it
// (ops/vit_block_ablation.py:cast_vector_bytes, qslice_vector_bytes).
template <int W>
struct BfVec;  // W bf16 values in, W int8 values out
template <>
struct BfVec<8> { using In = uint4; using Out = uint2; };
template <>
struct BfVec<2> { using In = uint32_t; using Out = uint16_t; };
template <>
struct BfVec<1> { using In = uint16_t; using Out = uint8_t; };

// f(j, f32(value j)) of a loaded vector, the W int8 results packed for one
// store
template <int W, typename F>
__device__ __forceinline__ typename BfVec<W>::Out narrow(
    typename BfVec<W>::In raw, F f) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint32_t word[(W + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < W; ++j)
    word[j / 4] |= (uint32_t)(uint8_t)f(j, __bfloat162float(e[j]))
                   << (8 * (j % 4));
  if constexpr (W == 8)
    return make_uint2(word[0], word[1]);
  else
    return (typename BfVec<W>::Out)word[0];
}

// q[i] = cast(f32(x[i])), the first link of the mm_only chain, over n
// values: n / W vectors, then the n % W values of the tail. A grid of the
// blocks the card holds at once strides over the vectors, neighbouring
// threads on neighbouring vectors; each thread has CAST_UNROLL loads in
// flight before their stores. Thread g < n % W of the grid takes tail value
// g.
constexpr int CAST_THREADS = 256;
constexpr int CAST_UNROLL = 4;

template <int W>
__global__ void __launch_bounds__(CAST_THREADS) cast_rows_kernel(
    const typename BfVec<W>::In* __restrict__ x,
    typename BfVec<W>::Out* __restrict__ q, size_t nvec, int tail) {
  const auto cast = [](int, float v) { return cast_i8(v); };
  const size_t stride = (size_t)gridDim.x * CAST_THREADS;
  const size_t first = (size_t)blockIdx.x * CAST_THREADS + threadIdx.x;
  size_t i = first;
  for (; i + (CAST_UNROLL - 1) * stride < nvec; i += CAST_UNROLL * stride) {
    typename BfVec<W>::In r[CAST_UNROLL];
#pragma unroll
    for (int u = 0; u < CAST_UNROLL; ++u) r[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < CAST_UNROLL; ++u)
      q[i + u * stride] = narrow<W>(r[u], cast);
  }
  for (; i < nvec; i += stride) q[i] = narrow<W>(x[i], cast);
  if (first < (size_t)tail) {
    const bf16* xt = reinterpret_cast<const bf16*>(x + nvec);
    reinterpret_cast<int8_t*>(q + nvec)[first] =
        cast_i8(__bfloat162float(xt[first]));
  }
}

// The grid is every SM times the blocks one holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once per device and
// form, or fewer blocks where there are fewer vectors.
template <int W>
int launch_cast_rows(int device, const void* x, void* q, size_t n,
                     cudaStream_t s) {
  static int resident[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cast_rows_kernel<W>, CAST_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident[device] = sms * per_sm;
  }
  const size_t nvec = n / W;
  const size_t need = (nvec + CAST_THREADS - 1) / CAST_THREADS;
  const int blocks =
      need < 1 ? 1 : (need < (size_t)resident[device] ? (int)need
                                                      : resident[device]);
  cast_rows_kernel<W><<<blocks, CAST_THREADS, 0, s>>>(
      (const typename BfVec<W>::In*)x, (typename BfVec<W>::Out*)q, nvec,
      (int)(n % W));
  return (int)cudaGetLastError();
}

// inv's W f32 values at p (two float4 for W = 8)
template <int W>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (W == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

// out[r, c] = clip(round(f32(qkv[r, c]) * inv[c])) for c < C: the q third of
// each qkv row (rows row_stride values apart) times inv_proj, one f32
// product, rounded half to even and clipped. One warp per token row,
// QSLICE_ROWS rows a block: lane l takes the row's vectors l, l + 32, ... of
// W values (at ViT-H and W = 8, 160 vectors a row, 5 a lane), all its
// QSLICE_UNROLL loads in flight before their stores, and reads inv's W
// values beside each (5 KB at ViT-H, held in L1). Row and column come from
// the warp's row and the lane's vector: no division.
constexpr int QSLICE_ROWS = 8;
constexpr int QSLICE_UNROLL = 8;

template <int W>
__global__ void __launch_bounds__(QSLICE_ROWS * 32) qslice_quant_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ inv,
    int8_t* __restrict__ out, long long rows, int C, long long row_stride) {
  using In = typename BfVec<W>::In;
  using Out = typename BfVec<W>::Out;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * QSLICE_ROWS + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int nvec = C / W;
  const In* src = reinterpret_cast<const In*>(qkv + row * row_stride);
  Out* dst = reinterpret_cast<Out*>(out + row * C);
  for (int base = lane; base < nvec; base += 32 * QSLICE_UNROLL) {
    In r[QSLICE_UNROLL];
#pragma unroll
    for (int u = 0; u < QSLICE_UNROLL; ++u)
      if (base + 32 * u < nvec) r[u] = src[base + 32 * u];
#pragma unroll
    for (int u = 0; u < QSLICE_UNROLL; ++u) {
      const int k = base + 32 * u;
      if (k < nvec) {
        float m[W];
        load_f32<W>(inv + (size_t)k * W, m);
        dst[k] = narrow<W>(r[u], [&](int j, float v) {
          return (int8_t)quant_clip(__fmul_rn(v, m[j]));
        });
      }
    }
  }
}

// (B, N, 3, H, D) -> (3, B*H, N, D). A token row (b, n) of qkv is 3H
// segments of D values back to back; segment seg = which * H + h lands
// contiguously at row ((which * B + b) * H + h) * N + n of the output. One
// warp per token row, SPLIT_ROWS rows a block: the warp reads its row as V
// vectors (uint4: D % 8 == 0 and both pointers 16-byte aligned; else
// uint32_t, D even), lane l taking vectors l, l + 32, ..., so the reads are
// coalesced across the row and the writes across each segment. Each lane
// divides once for its first (segment, vector) and then steps 32 vectors a
// time by adds; SPLIT_UNROLL loads are in flight before their stores.
constexpr int SPLIT_ROWS = 8;
constexpr int SPLIT_UNROLL = 4;

template <typename V>
__global__ void __launch_bounds__(SPLIT_ROWS * 32) heads_split_kernel(
    const V* __restrict__ qkv, V* __restrict__ out, int B, int N, int H,
    int segv) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * SPLIT_ROWS + threadIdx.x / 32;
  if (row >= B * N) return;  // warp-uniform
  const int b = row / N, n = row - b * N;
  const int per_row = 3 * H * segv;  // vectors of a token row
  const V* in = qkv + (size_t)row * per_row;
  // output vector of (which, h, v): which * which_stride + h * head_stride
  // + row_off + v
  const size_t head_stride = (size_t)N * segv;
  const size_t which_stride = (size_t)B * H * head_stride;
  const size_t row_off = (size_t)b * H * head_stride + (size_t)n * segv;
  int seg = lane / segv, v = lane - seg * segv;
  const int dseg = 32 / segv, dv = 32 - dseg * segv;
  for (int base = lane; base < per_row; base += 32 * SPLIT_UNROLL) {
    V r[SPLIT_UNROLL];
    size_t dst[SPLIT_UNROLL];
#pragma unroll
    for (int u = 0; u < SPLIT_UNROLL; ++u) {
      if (base + 32 * u < per_row) r[u] = in[base + 32 * u];
      const int which = seg >= 2 * H ? 2 : (seg >= H ? 1 : 0);
      dst[u] = which * which_stride + (size_t)(seg - which * H) * head_stride +
               row_off + v;
      seg += dseg;
      v += dv;
      if (v >= segv) v -= segv, ++seg;
    }
#pragma unroll
    for (int u = 0; u < SPLIT_UNROLL; ++u)
      if (base + 32 * u < per_row) out[dst[u]] = r[u];
  }
}

// f32 (B*H, N, D) -> int8 (B, N, H*D): clip(round(o * inv[h*D + d])), the
// inverse of heads_split. Output token row (b, n) is H segments of D values;
// segment h comes from row (b*H + h)*N + n of o. One warp per output row,
// MERGE_ROWS rows a block: lane l takes the row's vectors l, l + 32, ...
// (V = float4 with 4 int8 results packed into one 4-byte store Q: D % 4 ==
// 0, o and inv 16-byte aligned; else V = float, one byte a store), so the
// reads are coalesced along each segment and the writes along the output
// row. Each lane divides once for its first (segment, vector) and then
// steps 32 vectors a time by adds; MERGE_UNROLL loads are in flight before
// their stores.
constexpr int MERGE_ROWS = 8;
constexpr int MERGE_UNROLL = 4;

__device__ __forceinline__ int8_t merge_quant(float v, float inv) {
  return (int8_t)quant_clip(__fmul_rn(v, inv));
}

__device__ __forceinline__ uint32_t merge_quant(float4 v, float4 inv) {
  return (uint32_t)(uint8_t)merge_quant(v.x, inv.x) |
         (uint32_t)(uint8_t)merge_quant(v.y, inv.y) << 8 |
         (uint32_t)(uint8_t)merge_quant(v.z, inv.z) << 16 |
         (uint32_t)(uint8_t)merge_quant(v.w, inv.w) << 24;
}

template <typename V, typename Q>
__global__ void __launch_bounds__(MERGE_ROWS * 32) heads_merge_quant_kernel(
    const V* __restrict__ o, const V* __restrict__ inv, Q* __restrict__ out,
    int B, int N, int H, int segv) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * MERGE_ROWS + threadIdx.x / 32;
  if (row >= B * N) return;  // warp-uniform
  const int b = row / N, n = row - b * N;
  const int per_row = H * segv;  // vectors of an output row
  Q* dst = out + (size_t)row * per_row;
  // input vector of (segment h, v): src + h * head_stride + v
  const size_t head_stride = (size_t)N * segv;
  const V* src = o + ((size_t)b * H * N + n) * segv;
  int seg = lane / segv, v = lane - seg * segv;
  const int dseg = 32 / segv, dv = 32 - dseg * segv;
  for (int base = lane; base < per_row; base += 32 * MERGE_UNROLL) {
    V r[MERGE_UNROLL];
#pragma unroll
    for (int u = 0; u < MERGE_UNROLL; ++u) {
      if (base + 32 * u < per_row) r[u] = src[seg * head_stride + v];
      seg += dseg;
      v += dv;
      if (v >= segv) v -= segv, ++seg;
    }
#pragma unroll
    for (int u = 0; u < MERGE_UNROLL; ++u) {
      const int k = base + 32 * u;
      if (k < per_row) dst[k] = merge_quant(r[u], inv[k]);
    }
  }
}

// --------------------------------------------------------- GEMM knock-outs
enum {
  EPI_GELU_CAST = 0,  // int8 cast(gelu(acc*d + b) * inv_next)
  EPI_IDENT_Q8 = 1,   // int8 clip(round((acc*d + b) * inv_next))
  EPI_CAST = 2        // int8 cast(acc*d + b), the first keep_cols columns
};

// FAST: the tanh GELU of EPI_GELU_CAST (else the exact one), a template
// argument so that an inner tile's epilogue has no branch
template <int EPI, bool FAST = false>
struct AblationEpilogue {
  const float* col_scale;  // (N,)
  const float* bias;       // (N,)
  const float* inv_next;   // (N,), not for EPI_CAST
  int8_t* out;             // (M, N), or (M, keep_cols) for EPI_CAST
  int N;
  int keep_cols;

  // an inner tile's pairs start at even elements of the output's rows
  __device__ __forceinline__ bool aligned_pairs() const {
    return (EPI == EPI_CAST ? keep_cols : N) % 2 == 0;
  }

  static constexpr int SCRATCH_BYTES = 0;  // no table
  __device__ __forceinline__ void prepare(unsigned char*, int, int) {}

  __device__ __forceinline__ static int8_t finish(int acc, float d, float b,
                                                  float inv) {
    const float v = dequant_static(acc, d, b);
    if (EPI == EPI_GELU_CAST)
      return cast_i8((FAST ? gelu_tanh_f32(v) : gelu_erfc_f32(v)) * inv);
    if (EPI == EPI_IDENT_Q8) return (int8_t)quant_clip(v * inv);
    return cast_i8(v);
  }

  template <bool EDGE>
  __device__ __forceinline__ void store2(int a0, int a1, int gm, int gn,
                                         bool two) const {
    const int cols = EPI == EPI_CAST ? keep_cols : N;
    if (EPI == EPI_CAST && gn >= cols) return;  // the columns it drops
    if (EPI == EPI_CAST) two = two && gn + 1 < cols;
    const float2 cs = pair_load<EDGE>(col_scale + gn, two);
    const float2 b = pair_load<EDGE>(bias + gn, two);
    const float2 inv = EPI == EPI_CAST ? make_float2(0.f, 0.f)
                                       : pair_load<EDGE>(inv_next + gn, two);
    pair_store<EDGE>(out + (size_t)gm * cols + gn,
                     finish(a0, cs.x, b.x, inv.x),
                     finish(a1, cs.y, b.y, inv.y), two);
  }
};

// One launch of the int8 route; cudaErrorInvalidValue for a shape past the
// limits (the wrapper refuses those first): N up to ATTN_MAX_N, D a multiple
// of 4 up to ATTN_MAX_D, strides of whole 8-byte words.
int launch_i8(const void* q, const void* k, const void* v, void* out,
              const float* inv_out, int B, int N, int H, int D,
              long long batch_stride, long long row_stride, float q_mul,
              float kv_mul, float s_mul, float o_mul, cudaStream_t stream) {
  if (N < 1 || N > ATTN_MAX_N || D < 4 || D > ATTN_MAX_D || D % 4 ||
      batch_stride % 4 || row_stride % 4)
    return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  int8_t* o = (int8_t*)out;
  // 16-byte loads where every row and head starts on 16 bytes
  const bool wide = D % 8 == 0 && batch_stride % 8 == 0 &&
                    row_stride % 8 == 0 &&
                    ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (N <= 192)
    return wide ? launch_i8_kc<6, 8>(qb, kb, vb, o, inv_out, B, N, H, D,
                                     batch_stride, row_stride, q_mul, kv_mul,
                                     s_mul, o_mul, stream)
                : launch_i8_kc<6, 4>(qb, kb, vb, o, inv_out, B, N, H, D,
                                     batch_stride, row_stride, q_mul, kv_mul,
                                     s_mul, o_mul, stream);
  return wide ? launch_i8_kc<8, 8>(qb, kb, vb, o, inv_out, B, N, H, D,
                                   batch_stride, row_stride, q_mul, kv_mul,
                                   s_mul, o_mul, stream)
              : launch_i8_kc<8, 4>(qb, kb, vb, o, inv_out, B, N, H, D,
                                   batch_stride, row_stride, q_mul, kv_mul,
                                   s_mul, o_mul, stream);
}

}  // namespace

// --------------------------------------------------------- C interface
// Pointers and the stream come from PyTorch as integers; every entry returns
// the launch's cudaGetLastError() (0 = success) and never synchronises.
extern "C" {

// exactly one of no_ln (ln_affine_quant) and cast (ln_cast): neither is the
// serving ln_quant; C a multiple of 8 up to WARP_ROW_MAX_C, as ln_quant's
int abl_ln(int device, const void* x, const void* scale, const void* bias,
           void* q, int rows, int C, float eps, int no_ln, int cast,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || C < 8 || C > WARP_ROW_MAX_C || C % 8 || !no_ln == !cast)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return no_ln ? launch_ln_ablation<true>(x, scale, bias, q, rows, C, eps, s)
               : launch_ln_ablation<false>(x, scale, bias, q, rows, C, eps, s);
}

// vec_bytes 16 (x 16-byte and q 8-byte aligned), 4 (x 4-byte and q 2-byte
// aligned) or 2: the width of the loads, picked by the caller
// (ops/vit_block_ablation.py:cast_vector_bytes)
int abl_cast_rows(int device, const void* x, void* q, long long n,
                  int vec_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || (vec_bytes != 16 && vec_bytes != 4 && vec_bytes != 2) ||
      (uintptr_t)x % vec_bytes || (uintptr_t)q % (vec_bytes / 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_bytes == 16) return launch_cast_rows<8>(device, x, q, n, s);
  if (vec_bytes == 4) return launch_cast_rows<2>(device, x, q, n, s);
  return launch_cast_rows<1>(device, x, q, n, s);
}

// vec_bytes 16 (C and row_stride multiples of 8, qkv and inv 16-byte and out
// 8-byte aligned), 4 (C and row_stride even, qkv 4-byte, inv 8-byte and out
// 2-byte aligned) or 2: the width of the loads, picked by the caller
// (ops/vit_block_ablation.py:qslice_vector_bytes)
int abl_qslice_quant(int device, const void* qkv, const void* inv, void* out,
                     long long rows, int C, long long row_stride,
                     int vec_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int w = vec_bytes / 2;  // values a vector
  if (rows < 1 || C < 1 || row_stride < C ||
      (vec_bytes != 16 && vec_bytes != 4 && vec_bytes != 2) || C % w ||
      row_stride % w || (uintptr_t)qkv % vec_bytes ||
      (uintptr_t)inv % (w == 8 ? 16 : 4 * w) || (uintptr_t)out % w)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((rows + QSLICE_ROWS - 1) / QSLICE_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* x = (const bf16*)qkv;
  const float* m = (const float*)inv;
  int8_t* o = (int8_t*)out;
  if (w == 8)
    qslice_quant_kernel<8><<<blocks, QSLICE_ROWS * 32, 0, s>>>(
        x, m, o, rows, C, row_stride);
  else if (w == 2)
    qslice_quant_kernel<2><<<blocks, QSLICE_ROWS * 32, 0, s>>>(
        x, m, o, rows, C, row_stride);
  else
    qslice_quant_kernel<1><<<blocks, QSLICE_ROWS * 32, 0, s>>>(
        x, m, o, rows, C, row_stride);
  return (int)cudaGetLastError();
}

// vec_bytes 16 (D % 8 == 0, both pointers 16-byte aligned) or 4 (D even,
// both pointers 4-byte aligned): the width of the copy's vectors, picked by
// the caller (ops/vit_block_ablation.py:split_vector_bytes)
int abl_heads_split(int device, const void* qkv, void* out, int B, int N,
                    int H, int D, int vec_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t ptrs = (uintptr_t)qkv | (uintptr_t)out;
  if (B < 1 || N < 1 || H < 1 || D < 2 || D % 2 ||
      (vec_bytes != 16 && vec_bytes != 4) || ptrs % vec_bytes ||
      (vec_bytes == 16 && D % 8))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((size_t)B * N + SPLIT_ROWS - 1) / SPLIT_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_bytes == 16)
    heads_split_kernel<uint4><<<blocks, SPLIT_ROWS * 32, 0, s>>>(
        (const uint4*)qkv, (uint4*)out, B, N, H, D / 8);
  else
    heads_split_kernel<uint32_t><<<blocks, SPLIT_ROWS * 32, 0, s>>>(
        (const uint32_t*)qkv, (uint32_t*)out, B, N, H, D / 2);
  return (int)cudaGetLastError();
}

// vec_bytes 16 (D % 4 == 0, o and inv 16-byte aligned, out 4-byte aligned)
// or 4 (o and inv 4-byte aligned): the width of the reads, picked by the
// caller (ops/vit_block_ablation.py:merge_vector_bytes)
int abl_heads_merge_quant(int device, const void* o, const void* inv,
                          void* out, int B, int N, int H, int D,
                          int vec_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t ptrs = (uintptr_t)o | (uintptr_t)inv;
  if (B < 1 || N < 1 || H < 1 || D < 1 ||
      (vec_bytes != 16 && vec_bytes != 4) || ptrs % vec_bytes ||
      (vec_bytes == 16 && (D % 4 || (uintptr_t)out % 4)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((size_t)B * N + MERGE_ROWS - 1) / MERGE_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_bytes == 16)
    heads_merge_quant_kernel<float4, uint32_t>
        <<<blocks, MERGE_ROWS * 32, 0, s>>>((const float4*)o,
                                            (const float4*)inv,
                                            (uint32_t*)out, B, N, H, D / 4);
  else
    heads_merge_quant_kernel<float, int8_t><<<blocks, MERGE_ROWS * 32, 0, s>>>(
        (const float*)o, (const float*)inv, (int8_t*)out, B, N, H, D);
  return (int)cudaGetLastError();
}

// epi: EPI_GELU_CAST, EPI_IDENT_Q8 or EPI_CAST (then out is (M, keep_cols))
int abl_gemm(int device, const void* a, const void* w, const void* col_scale,
             const void* bias, const void* inv_next, void* out, int M, int N,
             int K, int epi, int fast_gelu, int keep_cols, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* ai = (const int8_t*)a;
  const int8_t* wi = (const int8_t*)w;
  const float* cs = (const float*)col_scale;
  const float* bi = (const float*)bias;
  const float* in = (const float*)inv_next;
  int8_t* o = (int8_t*)out;
  if (epi == EPI_GELU_CAST && in != nullptr && fast_gelu)
    return launch_gemm(ai, wi, AblationEpilogue<EPI_GELU_CAST, true>{
        cs, bi, in, o, N, N}, M, N, K, s);
  if (epi == EPI_GELU_CAST && in != nullptr)
    return launch_gemm(ai, wi, AblationEpilogue<EPI_GELU_CAST>{
        cs, bi, in, o, N, N}, M, N, K, s);
  if (epi == EPI_IDENT_Q8 && in != nullptr)
    return launch_gemm(ai, wi, AblationEpilogue<EPI_IDENT_Q8>{
        cs, bi, in, o, N, N}, M, N, K, s);
  if (epi == EPI_CAST && keep_cols > 0 && keep_cols <= N)
    return launch_gemm(ai, wi, AblationEpilogue<EPI_CAST>{
        cs, bi, in, o, N, keep_cols}, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

// mode: MODE_STATIC_CAST, MODE_STATIC_F32 or MODE_NO_SOFTMAX; bf16 q, k, v
int abl_attention(int device, const void* q, const void* k, const void* v,
                  void* out, const void* inv_out, int B, int N, int H, int D,
                  long long batch_stride, long long row_stride, float scale,
                  int mode, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* inv = (const float*)inv_out;
  if (mode == MODE_STATIC_CAST && inv != nullptr)
    return launch<MODE_STATIC_CAST>(q, k, v, out, inv, B, N, H, D,
                                    batch_stride, row_stride, scale, s);
  if (mode == MODE_STATIC_F32)
    return launch<MODE_STATIC_F32>(q, k, v, out, inv, B, N, H, D,
                                   batch_stride, row_stride, scale, s);
  if (mode == MODE_NO_SOFTMAX && inv != nullptr)
    return launch<MODE_NO_SOFTMAX>(q, k, v, out, inv, B, N, H, D,
                                   batch_stride, row_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

int abl_attention_i8(int device, const void* q, const void* k, const void* v,
                     void* out, const void* inv_out, int B, int N, int H,
                     int D, long long batch_stride, long long row_stride,
                     float q_mul, float kv_mul, float s_mul, float o_mul,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_i8(q, k, v, out, (const float*)inv_out, B, N, H, D,
                   batch_stride, row_stride, q_mul, kv_mul, s_mul, o_mul,
                   (cudaStream_t)stream);
}

const char* abl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
