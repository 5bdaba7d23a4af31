// The backward of the trainable ViT block for NVIDIA Hopper (sm_90a): three
// hand-written kernels behind a plain C interface (built with nvcc into a
// shared library and loaded with ctypes by hands_tpu_torch/ops/vit_block.py:
// attention_bwd, layernorm_bwd, gelu_bwd).
//
// Replaces: hands_tpu/ops/vit_block_pallas.py:461 vit_block_fused_trainable,
// whose backward (_trainable_bwd, :488) is jax.vjp of the block's XLA form.
// The port's backward (ops/vit_block.py:vit_block_backward) recomputes the
// block through vit_block.cu's kernels up to the MLP's pre-GELU activation,
// takes the eight gradient products with torch.matmul (XLA's products on the
// TPU) and runs the rest here, where autograd of the twin ran long chains of
// elementwise ops and f32 attention probabilities through device memory.
// Each kernel keeps the rounding points of the twin's autograd (the
// *_bwd_plain functions of ops/vit_block.py), and its sums run in PyTorch's
// order on the card where that order is known:
//   attention_bwd  per (batch row, head), MODE_BLOCK's backward: qs =
//                  bf16(q * scale), s = bf16(qs . k^T), p = f32 softmax(s)
//                  as the forward kernel forms it; dp = dO . V^T (f32, the
//                  products of bf16 values exact); dv = bf16(p^T . dO) with
//                  p in three bf16 parts; ds = bf16(p (dp - delta)), delta =
//                  sum_j dp p, as PyTorch's warp softmax backward forms them
//                  (tmp = dp * p; each lane sums keys l, l + 32, ...; a
//                  butterfly over 16 .. 1; tmp - p * delta contracted);
//                  dq = bf16(bf16(ds . k) * scale), dk = bf16(ds^T . qs)
//   layernorm_bwd  autograd of flax LayerNorm's f32 form (fast variance, the
//                  clamp's gate, mul = rsqrt(var + eps) * scale as one
//                  multiplier), the row's four gradient terms added in the
//                  autograd engine's order, plus the residual's gradient in
//                  bf16; dscale and dbias as per-block column sums, added up
//                  in block order by a second launch (column_sums)
//   gelu_bwd       the exact erfc GELU or the tanh form, every op rounded to
//                  bf16 as the twin: du (the terms that reach u added in the
//                  engine's order) and h = gelu(u), the forward epilogue's
//                  value
//
// What bounds them on this card: all three are bound by their bytes. At
// ViT-H (192 tokens, 16 heads of 80) the attention backward reads qkv and dO
// and writes dqkv, 9 bytes a token and channel, against ~10 N^2 D FLOPs a
// head: 8x under the bf16 ridge. The LayerNorm backward reads three bf16
// rows and writes one; the GELU backward reads two bf16 values and writes
// two. What the designs do about it:
//   attention_bwd  one thread block per (batch row, head), 12 warps, the
//                  way the forward kernel is built: mma.sync m16n8k16 with
//                  ldmatrix(.trans) operands from shared memory, rows padded
//                  by 8 bf16. Two buffers of N x D: K and V, then q * scale
//                  and dO. Pass A gives a warp 16 query rows: from its q and
//                  dO fragments (loaded from global memory) it sweeps the key
//                  tiles four times, recomputing s (and dp) instead of
//                  holding a row of them in registers: the row maxima, the
//                  row sums (the forward's order, so p is the forward's to
//                  the bit), delta, then dq. The three row statistics go to
//                  shared memory. Pass B gives a warp 16 key rows and
//                  rebuilds p^T and dp^T from them: one sweep over the
//                  queries for dv, one for dk. No atomics: every output has
//                  one writer, and the result is deterministic.
//   layernorm_bwd  a warp per row (common.cuh's warp_row_moments: the
//                  forward kernel's statistics to the bit), the row in
//                  registers, row sums by shuffles in PyTorch's CUDA order;
//                  a grid of the blocks the card holds at once, each lane
//                  keeping its columns' dscale and dbias sums over the rows
//                  it visits; the block adds its warps' sums in turn
//   gelu_bwd       a 16-byte vector pass (8 bf16 values a load, u and dh in,
//                  du and h out) over a grid of the resident blocks

#include "attention_kernel.cuh"

namespace {

// ------------------------------------------------------ attention backward
constexpr int BWD_WARPS = 12;  // warps a block; each takes 16-row tiles

// The A fragment (16 x 16 bf16) of rows r0 .. r0 + 15 and columns c0 .. c0 +
// 15 of a row-major matrix in global memory (row stride ld elements), rows
// from `rows` on zero; with SCALE each value times mul, rounded to bf16.
template <bool SCALE>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const bf16* __restrict__ m,
                                            long long ld, int r0, int c0,
                                            int rows, float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i % 2), c = c0 + t2 + 8 * (i / 2);
    uint32_t w = 0u;
    if (r < rows) w = *reinterpret_cast<const uint32_t*>(m + (size_t)r * ld + c);
    if constexpr (SCALE) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
      w = pack_bf16(__fmul_rn(f.x, mul), __fmul_rn(f.y, mul));
    }
    a[i] = w;
  }
}

// c[0] (columns 0-7) and c[1] (8-15) = a (16 rows x D) . (rows m0 .. m0 + 15
// of S)^T: the forward's q . k^T for one 16-key chunk, k-steps in order
template <int DT>
__device__ __forceinline__ void tile_dot(float (&c)[2][4],
                                         const uint32_t (&a)[DT][4],
                                         const bf16* S, int m0, int ld) {
  const int lane = threadIdx.x % 32, mat = lane / 8, mrow = lane % 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, S + (size_t)(m0 + (mat / 2) * 8 + mrow) * ld + kk * 16 +
                   (mat % 2) * 8);
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// acc (16 rows x D, n-tiles of 8 channels) += a (16 x 16) . rows m0 .. m0 +
// 15 of S (the product's depth along S's rows): the forward's p . v
template <int DT>
__device__ __forceinline__ void tile_acc(float (&acc)[2 * DT][4],
                                         const uint32_t (&a)[4],
                                         const bf16* S, int m0, int ld) {
  const int lane = threadIdx.x % 32, mat = lane / 8, mrow = lane % 8;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t b[4];
    ldsm_x4_t(b, S + (size_t)(m0 + (mat % 2) * 8 + mrow) * ld + kk * 16 +
                     (mat / 2) * 8);
    mma_bf16(acc[2 * kk], a, b[0], b[1]);
    mma_bf16(acc[2 * kk + 1], a, b[2], b[3]);
  }
}

// the bf16 logits of a warp's 16 query rows against key chunk kc, keys from
// N on -inf (MODE_BLOCK's rounding and mask)
template <int DT>
__device__ __forceinline__ void logits(float (&s)[2][4],
                                       const uint32_t (&qa)[DT][4],
                                       const bf16* K, int kc, int ld, int N) {
  const int t2 = (threadIdx.x % 4) * 2;
  tile_dot<DT>(s, qa, K, kc * 16, ld);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = kc * 16 + 8 * j + t2 + (e & 1) < N ? round_bf16(s[j][e])
                                                   : -INFINITY;
}

// 16 rows padded to NP of a (rows x D) slice (row stride ld) into S (row
// stride LD), rows from N on zero: 16-byte copies
template <int D>
__device__ __forceinline__ void stage_rows(bf16* S, const bf16* src,
                                           long long ld, int N, int NP) {
  constexpr int CHUNKS = D / 8, LD = D + ATTN_PAD;
  for (int idx = threadIdx.x; idx < NP * CHUNKS; idx += blockDim.x) {
    const int m = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    const bool ok = m < N;
    cp_async16(S + (size_t)m * LD + c, ok ? src + (size_t)m * ld + c : src,
               ok);
  }
}

// the same for q, each value times scale and rounded to bf16 on the way
template <int D>
__device__ __forceinline__ void stage_scaled(bf16* S, const bf16* src,
                                             long long ld, int N, int NP,
                                             float scale) {
  constexpr int CHUNKS = D / 8, LD = D + ATTN_PAD;
  for (int idx = threadIdx.x; idx < NP * CHUNKS; idx += blockDim.x) {
    const int m = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (m < N)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)m * ld + c);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[j]), scale));
    *reinterpret_cast<uint4*>(S + (size_t)m * LD + c) = raw;
  }
}

// one (batch row, head): qkv (N, 3C) rows of the batch row, dout (N, C);
// writes dq, dk, dv into dqkv's columns of the head. D = 16 DT.
template <int DT>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1) attention_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    bf16* __restrict__ dqkv, int N, int H, float scale) {
  constexpr int D = 16 * DT, LD = D + ATTN_PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = (N + 15) / 16, NP = nt * 16;
  bf16* X = reinterpret_cast<bf16*>(smem_raw);  // K, then q * scale
  bf16* Y = X + (size_t)NP * LD;                // V, then dO
  float* row_max = reinterpret_cast<float*>(Y + (size_t)NP * LD);
  float* row_sum = row_max + NP;
  float* row_rcp = row_sum + NP;  // recip(row_sum): p = div_by(e, sum, rcp)
  float* row_delta = row_rcp + NP;

  const long long C = (long long)H * D, C3 = 3 * C;
  const size_t tok0 = (size_t)blockIdx.y * N;
  const bf16* q = qkv + tok0 * C3 + (size_t)blockIdx.x * D;
  const bf16* k = q + C;
  const bf16* v = q + 2 * C;
  const bf16* go = dout + tok0 * C + (size_t)blockIdx.x * D;
  bf16* dq = dqkv + tok0 * C3 + (size_t)blockIdx.x * D;
  bf16* dk = dq + C;
  bf16* dv = dq + 2 * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;

  stage_rows<D>(X, k, C3, N, NP);
  stage_rows<D>(Y, v, C3, N, NP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- pass A: a warp per 16 query rows
  for (int tile = warp; tile < nt; tile += nwarps) {
    const int q0 = tile * 16;
    uint32_t qa[DT][4], da[DT][4];
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      load_a_frag<true>(qa[kk], q, C3, q0, kk * 16, N, scale);
      load_a_frag<false>(da[kk], go, C, q0, kk * 16, N, 1.f);
    }
    // the row maxima, then the sums of exp(s - max) in the forward's order
    // (s[j][0..1] are row g, s[j][2..3] row g + 8)
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    for (int kc = 0; kc < nt; ++kc) {
      float s[2][4];
      logits<DT>(s, qa, X, kc, LD, N);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    for (int kc = 0; kc < nt; ++kc) {
      float s[2][4];
      logits<DT>(s, qa, X, kc, LD, N);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e / 2] += expf(s[j][e] - mx[e / 2]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
    // p = e / sum as the IEEE division forms it (attention_kernel.cuh's
    // div_by: correctly rounded for e <= sum in [1, 256] down to 2^-126)
    const float rcp[2] = {recip(sum[0]), recip(sum[1])};
    // delta = sum_j dp p in the order of PyTorch's warp softmax backward:
    // lane l of its warp adds tmp = dp * p of keys l, l + 32, ... in turn.
    // Key 32i + l of a row lies in this quad at l = 8a + 2t + e (n-tile 4i +
    // a, element e): this thread keeps the sums of lanes 8a + 2t + e, the
    // butterfly's steps 16 and 8 are its own adds, 4 and 2 quad shuffles,
    // 1 its last add (attention_i8_kernel sums its softmax so)
    float lane_sum[2][4][2] = {};  // [row g / g + 8][a][e]
    for (int kc = 0; kc < nt; kc += 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // n-tiles 2 kc + 2 half + j
        if (kc + half < nt) {
          float s[2][4], dp[2][4];
          logits<DT>(s, qa, X, kc + half, LD, N);
          tile_dot<DT>(dp, da, Y, (kc + half) * 16, LD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = div_by(expf(s[j][e] - mx[e / 2]), sum[e / 2],
                                     rcp[e / 2]);
              lane_sum[e / 2][2 * half + j][e % 2] += __fmul_rn(dp[j][e], p);
            }
        }
      }
    }
    float delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float (&ls)[4][2] = lane_sum[r];
        x[e] = (ls[0][e] + ls[2][e]) + (ls[1][e] + ls[3][e]);
        x[e] += __shfl_xor_sync(0xffffffffu, x[e], 2);
        x[e] += __shfl_xor_sync(0xffffffffu, x[e], 1);
      }
      delta[r] = x[0] + x[1];
    }
    if (t2 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_max[q0 + g + 8 * r] = mx[r];
        row_sum[q0 + g + 8 * r] = sum[r];
        row_rcp[q0 + g + 8 * r] = rcp[r];
        row_delta[q0 + g + 8 * r] = delta[r];
      }
    }
    // dq = bf16(bf16(ds . k) * scale), ds = bf16(tmp - p delta)
    float acc[2 * DT][4];
#pragma unroll
    for (int n = 0; n < 2 * DT; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kc = 0; kc < nt; ++kc) {
      float s[2][4], dp[2][4];
      logits<DT>(s, qa, X, kc, LD, N);
      tile_dot<DT>(dp, da, Y, kc * 16, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              div_by(expf(s[j][e] - mx[e / 2]), sum[e / 2], rcp[e / 2]);
          s[j][e] = fmaf(-p, delta[e / 2], __fmul_rn(dp[j][e], p));
        }
      uint32_t a[1][4];
      a_fragments<1>(s[0], s[1], a);
      tile_acc<DT>(acc, a[0], X, kc * 16, LD);
    }
#pragma unroll
    for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row < N)
          *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)row * C3 + 8 * n +
                                             t2) =
              __floats2bfloat162_rn(
                  __fmul_rn(round_bf16(acc[n][2 * r]), scale),
                  __fmul_rn(round_bf16(acc[n][2 * r + 1]), scale));
      }
  }
  __syncthreads();  // every warp is done with K and V

  stage_scaled<D>(X, q, C3, N, NP, scale);
  stage_rows<D>(Y, go, C, N, NP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- pass B: a warp per 16 key rows; s^T[j][e] holds key j0 + g + 8 (e
  // / 2) against query qc * 16 + 8 j + t2 + (e & 1)
  for (int tile = warp; tile < nt; tile += nwarps) {
    const int j0 = tile * 16;
    // p^T from the row statistics: the forward's expf(s - max) / sum
    const auto probs = [&](float (&s)[2][4], int qc) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc * 16 + 8 * j + t2 + (e & 1);
          const bool ok = qi < N && j0 + g + 8 * (e / 2) < N;
          s[j][e] = ok ? div_by(expf(round_bf16(s[j][e]) - row_max[qi]),
                                row_sum[qi], row_rcp[qi])
                       : 0.f;
        }
    };
    const auto store = [&](bf16* dst, const float (&hi)[2 * DT][4],
                           const float (&lo)[2 * DT][4], bool two) {
#pragma unroll
      for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = j0 + g + 8 * r;
          float v0 = hi[n][2 * r], v1 = hi[n][2 * r + 1];
          if (two) v0 += lo[n][2 * r], v1 += lo[n][2 * r + 1];
          if (row < N)
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * C3 +
                                               8 * n + t2) =
                __floats2bfloat162_rn(v0, v1);
        }
    };
    uint32_t ka[DT][4];
#pragma unroll
    for (int kk = 0; kk < DT; ++kk)
      load_a_frag<false>(ka[kk], k, C3, j0, kk * 16, N, 1.f);
    {
      // dv = p^T . dO, p = hi + mid + lo in bf16 parts: hi into acc, mid
      // and lo into acc_lo (as the forward's p . v)
      float acc[2 * DT][4], acc_lo[2 * DT][4];
#pragma unroll
      for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = acc_lo[n][e] = 0.f;
      for (int qc = 0; qc < nt; ++qc) {
        float s[2][4];
        tile_dot<DT>(s, ka, X, qc * 16, LD);
        probs(s, qc);
        uint32_t pf[3][4];
        a_fragments<3>(s[0], s[1], pf);
        tile_acc<DT>(acc, pf[0], Y, qc * 16, LD);
        tile_acc<DT>(acc_lo, pf[1], Y, qc * 16, LD);
        tile_acc<DT>(acc_lo, pf[2], Y, qc * 16, LD);
      }
      store(dv, acc, acc_lo, true);
    }
    {
      // dk = ds^T . (q * scale), ds from p^T and dp^T = (V . dO^T) rows
      uint32_t va[DT][4];
#pragma unroll
      for (int kk = 0; kk < DT; ++kk)
        load_a_frag<false>(va[kk], v, C3, j0, kk * 16, N, 1.f);
      float acc[2 * DT][4];
#pragma unroll
      for (int n = 0; n < 2 * DT; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int qc = 0; qc < nt; ++qc) {
        float s[2][4], dp[2][4];
        tile_dot<DT>(s, ka, X, qc * 16, LD);
        probs(s, qc);
        tile_dot<DT>(dp, va, Y, qc * 16, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qc * 16 + 8 * j + t2 + (e & 1);  // < NP
            s[j][e] = fmaf(-s[j][e], row_delta[qi],
                           __fmul_rn(dp[j][e], s[j][e]));
          }
        uint32_t a[1][4];
        a_fragments<1>(s[0], s[1], a);
        tile_acc<DT>(acc, a[0], X, qc * 16, LD);
      }
      store(dk, acc, acc, false);
    }
  }
}

template <int DT>
int launch_attention_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv,
                         int B, int N, int H, float scale,
                         cudaStream_t stream) {
  constexpr int LD = 16 * DT + ATTN_PAD;
  const int nt = (N + 15) / 16, NP = nt * 16;
  const int warps = min(nt, BWD_WARPS);
  const size_t smem = 2 * (size_t)NP * LD * sizeof(bf16) +
                      4 * (size_t)NP * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<DT><<<dim3(H, B), warps * 32, smem, stream>>>(
      qkv, dout, dqkv, N, H, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ LayerNorm backward
// sum of a row's values held as ((a0 + a1) + a2) + a3 a lane, then the
// butterfly: common.cuh's order, PyTorch's CUDA row reduction
__device__ __forceinline__ float row_total(const float (&a)[4]) {
  return warp_sum(__fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]));
}

// the 4 bf16 values of a raw uint2 (the first in the low half) as floats
__device__ __forceinline__ void unpack4(uint2 raw, float* v) {
  v[0] = __uint_as_float(raw.x << 16);
  v[1] = __uint_as_float(raw.x & 0xffff0000u);
  v[2] = __uint_as_float(raw.y << 16);
  v[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// A warp per row, WARP_ROWS rows a block at a time, the grid striding over
// the rows. Per row, with r = rsqrt(max(dvar, 0) + eps) and mul = r * scale:
//   g_xc = dy mul, g_mul = dy (x - mu); g_mu = -sum g_xc, g_r = sum g_mul
//   scale; g_dvar = dvar >= 0 ? -0.5 g_r r^3 : 0; g_mu += 2 (-g_dvar mu) (two
//   adds); dx = ((g_xc + g_sq x) + g_sq x) + g_mu / C with g_sq = g_dvar / C
//   (the divisions by C as PyTorch's CUDA division by a scalar: times
//   RN(1/C)); out = bf16(g_res + bf16(dx)).
// The row's dy and g_res are loaded raw (4 bf16 a uint2) beside x, so a
// row costs one memory round trip. Each warp keeps its column sums of
// dscale (g_mul r) and dbias (dy) in a slice of shared memory that only its
// lanes touch; at the end the block adds the slices in warp order and
// writes one row of `partial` (dscale, then dbias). The registers (a row of
// x as floats, two raw rows) leave room for two blocks an SM at C = 1280;
// the wrapper launches two blocks an SM (ops/vit_block.py:_ln_bwd_blocks),
// fewer where there are fewer rows.
template <int NV>
__global__ void __launch_bounds__(WARP_ROWS * 32, 2) layernorm_bwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ scale, const bf16* __restrict__ g_res,
    bf16* __restrict__ dx, float* __restrict__ partial, int rows, int C,
    float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cols = reinterpret_cast<float*>(smem_raw);  // WARP_ROWS x 2 x C
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nvec = C / 4;
  const float inv_c = 1.f / (float)C;
  float4* ds_acc = reinterpret_cast<float4*>(cols + (size_t)warp * 2 * C);
  float4* db_acc = ds_acc + nvec;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * 32 + lane;
    if (vi < nvec)
      ds_acc[vi] = db_acc[vi] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int row = blockIdx.x * WARP_ROWS + warp; row < rows;
       row += gridDim.x * WARP_ROWS) {
    const size_t base = (size_t)row * C;
    uint2 dy_raw[NV], gr_raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * 32 + lane;
      dy_raw[i] = gr_raw[i] = make_uint2(0u, 0u);
      if (vi < nvec) {
        dy_raw[i] = reinterpret_cast<const uint2*>(dy + base)[vi];
        gr_raw[i] = reinterpret_cast<const uint2*>(g_res + base)[vi];
      }
    }
    float v[NV][4], mu, m2;
    warp_row_moments<bf16, NV>(x + base, C, v, mu, m2);
    const float dvar = __fsub_rn(m2, __fmul_rn(mu, mu));
    const float r = rsqrtf(fmaxf(dvar, 0.f) + eps);
    float a_xc[4] = {0.f, 0.f, 0.f, 0.f}, a_r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * 32 + lane;
      float gy[4], sc[4] = {0.f, 0.f, 0.f, 0.f};
      unpack4(dy_raw[i], gy);
      if (vi < nvec) load4(scale + (size_t)vi * 4, sc);
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float g_mul = __fmul_rn(gy[j], __fsub_rn(v[i][j], mu));
        a_xc[j] = __fadd_rn(a_xc[j], __fmul_rn(gy[j], __fmul_rn(r, sc[j])));
        a_r[j] = __fadd_rn(a_r[j], __fmul_rn(g_mul, sc[j]));
        ds[j] = __fmul_rn(g_mul, r);
      }
      if (vi < nvec) {
        float4 a = ds_acc[vi], b = db_acc[vi];
        ds_acc[vi] = make_float4(__fadd_rn(a.x, ds[0]), __fadd_rn(a.y, ds[1]),
                                 __fadd_rn(a.z, ds[2]), __fadd_rn(a.w, ds[3]));
        db_acc[vi] = make_float4(__fadd_rn(b.x, gy[0]), __fadd_rn(b.y, gy[1]),
                                 __fadd_rn(b.z, gy[2]), __fadd_rn(b.w, gy[3]));
      }
    }
    const float g_r = row_total(a_r);
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float g_dvar =
        dvar >= 0.f ? __fmul_rn(__fmul_rn(g_r, -0.5f), r3) : 0.f;
    const float g_mumu = -g_dvar;
    const float g_mu = __fadd_rn(
        __fadd_rn(-row_total(a_xc), __fmul_rn(g_mumu, mu)),
        __fmul_rn(g_mumu, mu));
    const float g_sq = __fmul_rn(g_dvar, inv_c);
    const float g_c = __fmul_rn(g_mu, inv_c);
    uint2* outr = reinterpret_cast<uint2*>(dx + base);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * 32 + lane;
      if (vi < nvec) {
        float gy[4], gr[4], sc[4], o[4];
        unpack4(dy_raw[i], gy);
        unpack4(gr_raw[i], gr);
        load4(scale + (size_t)vi * 4, sc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float g_xc = __fmul_rn(gy[j], __fmul_rn(r, sc[j]));
          const float sq = __fmul_rn(g_sq, v[i][j]);
          const float d =
              __fadd_rn(__fadd_rn(__fadd_rn(g_xc, sq), sq), g_c);
          o[j] = __fadd_rn(gr[j], round_bf16(d));
        }
        outr[vi] = make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
      }
    }
  }
  // the block's column sums: the warps' slices added in warp order
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float t = cols[c];
#pragma unroll
    for (int w = 1; w < WARP_ROWS; ++w)
      t = __fadd_rn(t, cols[(size_t)w * 2 * C + c]);
    partial[(size_t)blockIdx.x * 2 * C + c] = t;
  }
}

// dynamic shared memory of a LayerNorm backward block: each warp's column
// sums of dscale and dbias
size_t layernorm_bwd_smem(int C) {
  return (size_t)WARP_ROWS * 2 * C * sizeof(float);
}

// out[c] = sum over the blocks b = 0, 1, ... of partial[b][c], in that order
constexpr int SUM_THREADS = 256;

__global__ void __launch_bounds__(SUM_THREADS) column_sums_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int blocks,
    int cols) {
  const int c = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b)
    s = __fadd_rn(s, partial[(size_t)b * cols + c]);
  out[c] = s;
}

// ----------------------------------------------------------- GELU backward
// Tables of a function of a bf16 argument, for the arguments with 2^-16 <=
// |x| < 16 (two signs, exponents 2^-16 .. 2^3, 128 mantissas each), as f32:
// erfcf, expf(-(x x)) and tanhf of a bf16 value are all the GELU backward
// evaluates, so a table gives their results bit for bit at a shared-memory
// load instead of tens of instructions. Arguments outside the table (tiny,
// huge, NaN) take the function itself.
constexpr int TABLE_EXP_LO = 127 - 16;  // the exponent field of 2^-16
constexpr int TABLE_ENTRIES = 20 * 128;  // one sign

__device__ __forceinline__ float table_argument(int k) {
  const uint32_t sign = k < TABLE_ENTRIES ? 0u : 1u;
  const uint32_t bits = (uint32_t)(TABLE_EXP_LO * 128 + k % TABLE_ENTRIES);
  return __uint_as_float(sign << 31 | bits << 16);
}

// the entry of a bf16 value x, or -1 outside the table
__device__ __forceinline__ int table_index(float x) {
  const uint32_t bits = __float_as_uint(x);
  const int i = (int)((bits & 0x7fffffffu) >> 16) - TABLE_EXP_LO * 128;
  return (unsigned)i < (unsigned)TABLE_ENTRIES
             ? (int)(bits >> 31) * TABLE_ENTRIES + i
             : -1;
}

__device__ __forceinline__ float erfc_of(float d) { return erfcf(d); }
__device__ __forceinline__ float exp_neg_square(float d) {
  return expf(-__fmul_rn(d, d));
}
__device__ __forceinline__ float tanh_of(float x) { return tanhf(x); }

constexpr float SQRT_HALF_BF16 = 0.70703125f;  // bf16(2^-0.5)
constexpr float SQRT_2_PI_BF16 = 0.796875f;    // bf16(sqrt(2 / pi))
constexpr float TANH_K_BF16 = 0.044677734375f;  // bf16(0.044715)
constexpr float ERFC_SLOPE = -1.1283791670955126f;  // f32(-2 / sqrt(pi))

// du and h = gelu(x) for a bf16 value x and its bf16 gradient g; every
// product rounded to bf16 as the twin's bf16 tensors round it. T holds the
// tables: erfc and exp(-d^2) (exact form), tanh (FAST).
template <bool FAST>
__device__ __forceinline__ void gelu_backward(float x, float g, float& du,
                                              float& h, const float* T) {
  if constexpr (FAST) {
    const float xx = round_bf16(__fmul_rn(x, x));
    const float x3 = round_bf16(__fmul_rn(x, xx));
    const float kx3 = round_bf16(__fmul_rn(x3, TANH_K_BF16));
    const float sx = round_bf16(__fadd_rn(x, kx3));
    const float inner = round_bf16(__fmul_rn(sx, SQRT_2_PI_BF16));
    const int k = table_index(inner);
    const float t32 = k >= 0 ? T[k] : tanh_of(inner);
    const float a = round_bf16(__fadd_rn(round_bf16(t32), 1.f));
    const float cdf = round_bf16(__fmul_rn(a, 0.5f));
    h = round_bf16(__fmul_rn(x, cdf));
    const float g_t = round_bf16(__fmul_rn(round_bf16(__fmul_rn(g, x)), 0.5f));
    // PyTorch's tanh_backward on the card: g (1 - t^2), the square fused
    const float g_inner = round_bf16(__fmul_rn(g_t, fmaf(-t32, t32, 1.f)));
    const float g_s = round_bf16(__fmul_rn(g_inner, SQRT_2_PI_BF16));
    const float g_x3 = round_bf16(__fmul_rn(g_s, TANH_K_BF16));
    const float g_xx = round_bf16(__fmul_rn(g_x3, x));
    const float g_xd = round_bf16(__fmul_rn(g_xx, x));
    // the five terms that reach x, in the order the engine adds them
    float s = round_bf16(__fadd_rn(round_bf16(__fmul_rn(g, cdf)), g_s));
    s = round_bf16(__fadd_rn(s, round_bf16(__fmul_rn(g_x3, xx))));
    s = round_bf16(__fadd_rn(s, g_xd));
    du = round_bf16(__fadd_rn(s, g_xd));
  } else {
    const float half_x = round_bf16(__fmul_rn(x, 0.5f));
    const float d = round_bf16(__fmul_rn(-x, SQRT_HALF_BF16));
    const int k = table_index(d);
    const float e = round_bf16(k >= 0 ? T[k] : erfc_of(d));
    h = round_bf16(__fmul_rn(half_x, e));
    const float g_e = round_bf16(__fmul_rn(g, half_x));
    // erfc': -2/sqrt(pi) exp(-d^2), times the gradient
    const float ex = k >= 0 ? T[2 * TABLE_ENTRIES + k] : exp_neg_square(d);
    const float g_d = round_bf16(__fmul_rn(__fmul_rn(ERFC_SLOPE, ex), g_e));
    const float g_neg = round_bf16(__fmul_rn(g_d, SQRT_HALF_BF16));
    const float g_half = round_bf16(__fmul_rn(g, e));
    du = round_bf16(__fadd_rn(-g_neg, round_bf16(__fmul_rn(g_half, 0.5f))));
  }
}

template <bool FAST>
__device__ __forceinline__ void gelu_vector(const uint4& u, const uint4& g,
                                            uint4& du, uint4& h,
                                            const float* T) {
  const bf16* ue = reinterpret_cast<const bf16*>(&u);
  const bf16* ge = reinterpret_cast<const bf16*>(&g);
  uint32_t* dw = reinterpret_cast<uint32_t*>(&du);
  uint32_t* hw = reinterpret_cast<uint32_t*>(&h);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float d0, d1, h0, h1;
    gelu_backward<FAST>(__bfloat162float(ue[2 * j]),
                        __bfloat162float(ge[2 * j]), d0, h0, T);
    gelu_backward<FAST>(__bfloat162float(ue[2 * j + 1]),
                        __bfloat162float(ge[2 * j + 1]), d1, h1, T);
    dw[j] = pack_bf16(d0, d1);
    hw[j] = pack_bf16(h0, h1);
  }
}

// nvec vectors of 8 values, then the n % 8 values of the tail (thread g <
// tail of the grid takes value g); a grid of the resident blocks strides
// over the vectors with GELU_UNROLL loads of each input in flight a thread
constexpr int GELU_THREADS = 256;
constexpr int GELU_UNROLL = 2;

template <bool FAST>
__global__ void __launch_bounds__(GELU_THREADS) gelu_bwd_kernel(
    const uint4* __restrict__ u, const uint4* __restrict__ dh,
    uint4* __restrict__ du, uint4* __restrict__ h, size_t nvec, int tail) {
  // the exact form's erfc and exp(-d^2) tables, or the tanh form's tanh
  __shared__ float T[(FAST ? 2 : 4) * TABLE_ENTRIES];
  for (int k = threadIdx.x; k < 2 * TABLE_ENTRIES; k += GELU_THREADS) {
    const float a = table_argument(k);
    if constexpr (FAST) {
      T[k] = tanh_of(a);
    } else {
      T[k] = erfc_of(a);
      T[2 * TABLE_ENTRIES + k] = exp_neg_square(a);
    }
  }
  __syncthreads();
  const size_t stride = (size_t)gridDim.x * GELU_THREADS;
  const size_t first = (size_t)blockIdx.x * GELU_THREADS + threadIdx.x;
  size_t i = first;
  for (; i + (GELU_UNROLL - 1) * stride < nvec; i += GELU_UNROLL * stride) {
    uint4 a[GELU_UNROLL], b[GELU_UNROLL];
#pragma unroll
    for (int k = 0; k < GELU_UNROLL; ++k) {
      a[k] = u[i + k * stride];
      b[k] = dh[i + k * stride];
    }
#pragma unroll
    for (int k = 0; k < GELU_UNROLL; ++k) {
      uint4 d, o;
      gelu_vector<FAST>(a[k], b[k], d, o, T);
      du[i + k * stride] = d;
      h[i + k * stride] = o;
    }
  }
  for (; i < nvec; i += stride) {
    uint4 d, o;
    gelu_vector<FAST>(u[i], dh[i], d, o, T);
    du[i] = d;
    h[i] = o;
  }
  if (first < (size_t)tail) {
    const size_t t = nvec * 8 + first;
    float d, o;
    gelu_backward<FAST>(
        __bfloat162float(reinterpret_cast<const bf16*>(u)[t]),
        __bfloat162float(reinterpret_cast<const bf16*>(dh)[t]), d, o, T);
    reinterpret_cast<bf16*>(du)[t] = __float2bfloat16_rn(d);
    reinterpret_cast<bf16*>(h)[t] = __float2bfloat16_rn(o);
  }
}

constexpr int MAX_DEVICES = 64;

// The grid is every SM times the blocks one holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once per device and
// form, or fewer blocks where there are fewer vectors.
template <bool FAST>
int launch_gelu_bwd(int device, const void* u, const void* dh, void* du,
                    void* h, size_t n, cudaStream_t s) {
  static int resident[MAX_DEVICES] = {};
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gelu_bwd_kernel<FAST>, GELU_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident[device] = sms * max(per_sm, 1);
  }
  const size_t nvec = n / 8;
  const size_t need = (nvec + GELU_THREADS - 1) / GELU_THREADS;
  const int blocks = need < 1 ? 1
                     : need < (size_t)resident[device] ? (int)need
                                                       : resident[device];
  gelu_bwd_kernel<FAST><<<blocks, GELU_THREADS, 0, s>>>(
      (const uint4*)u, (const uint4*)dh, (uint4*)du, (uint4*)h, nvec,
      (int)(n % 8));
  return (int)cudaGetLastError();
}

}  // namespace

// --------------------------------------------------------- C interface
// Pointers and the stream come from PyTorch as integers; every entry returns
// the launch's cudaGetLastError() (0 = success) and never synchronises.
extern "C" {

// qkv (B*N, 3C) with column s*C + h*D + d (s = q, k, v), dout (B*N, C) ->
// dqkv (B*N, 3C); D a multiple of 16 up to 128, N up to 256
int vbb_attention_bwd(int device, const void* qkv, const void* dout,
                      void* dqkv, int B, int N, int H, int D, float scale,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || H < 1 || N < 1 || N > ATTN_MAX_N || D < 16 ||
      D > ATTN_MAX_D || D % 16)
    return (int)cudaErrorInvalidValue;
  const bf16* a = (const bf16*)qkv;
  const bf16* g = (const bf16*)dout;
  bf16* o = (bf16*)dqkv;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D / 16) {
    case 1: return launch_attention_bwd<1>(a, g, o, B, N, H, scale, s);
    case 2: return launch_attention_bwd<2>(a, g, o, B, N, H, scale, s);
    case 3: return launch_attention_bwd<3>(a, g, o, B, N, H, scale, s);
    case 4: return launch_attention_bwd<4>(a, g, o, B, N, H, scale, s);
    case 5: return launch_attention_bwd<5>(a, g, o, B, N, H, scale, s);
    case 6: return launch_attention_bwd<6>(a, g, o, B, N, H, scale, s);
    case 7: return launch_attention_bwd<7>(a, g, o, B, N, H, scale, s);
    default: return launch_attention_bwd<8>(a, g, o, B, N, H, scale, s);
  }
}

// x, dy, g_res (rows, C) bf16, scale (C,) f32 -> dx (rows, C) bf16 and
// partial (blocks, 2, C) f32: each block's column sums of dscale and dbias
int vbb_layernorm_bwd(int device, const void* x, const void* dy,
                      const void* scale, const void* g_res, void* dx,
                      void* partial, int rows, int C, int blocks, float eps,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || blocks < 1 || C < 8 || C > WARP_ROW_MAX_C || C % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = layernorm_bwd_smem(C);
  return with_row_vectors(C, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    cudaError_t e = cudaFuncSetAttribute(
        layernorm_bwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    layernorm_bwd_kernel<NV><<<blocks, WARP_ROWS * 32, smem, s>>>(
        (const bf16*)x, (const bf16*)dy, (const float*)scale,
        (const bf16*)g_res, (bf16*)dx, (float*)partial, rows, C, eps);
    return (int)cudaGetLastError();
  });
}

// out (cols,) f32 = the sum of partial (blocks, cols) over its rows, in order
int vbb_column_sums(int device, const void* partial, void* out, int blocks,
                    int cols, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  column_sums_kernel<<<(cols + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                       (cudaStream_t)stream>>>((const float*)partial,
                                               (float*)out, blocks, cols);
  return (int)cudaGetLastError();
}

// u, dh (n,) bf16 -> du, h (n,) bf16, all 16-byte aligned; fast: tanh form
int vbb_gelu_bwd(int device, const void* u, const void* dh, void* du,
                 void* h, long long n, int fast, void* stream) {
  if (device < 0 || device >= MAX_DEVICES || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return fast ? launch_gelu_bwd<true>(device, u, dh, du, h, (size_t)n, s)
              : launch_gelu_bwd<false>(device, u, dh, du, h, (size_t)n, s);
}

const char* vbb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
