// The f32 route of K7's mha_fused (MODE_MHA on f32 q, k, v, the JAX test's
// type and the f32 ViTBackbone(fused_attn=True)'s), included by attention.cu
// only. Its arithmetic: logits = q.k^T in f32 times `scale` after the dot,
// the row maximum, exp(s - max), the row sum, p = e / sum as a division, o =
// p.v accumulated in f32, f32 out; q, k and v read in place through a batch
// stride and a row stride (in elements), head h starts h*D elements into a
// row.
//
// What bounds it on this card: at ViT-H (N 192, D 80, 16 crops of 16 heads)
// q, k, v and o are 62.9 MB of f32, 0.0188 ms at 3.35 TB/s; the 3.02 GFLOP
// of the two products take 0.0451 ms on the f32 CUDA cores (67 TFLOP/s) and,
// three TF32 products each (below), 0.0183 ms on the TF32 tensor cores (495
// TFLOP/s dense): on the tensor cores bytes bound it.
//
// Tensor-core route (N <= TF32_MAX_N, D <= TF32_MAX_D and the head's K and V
// within shared memory): the bf16 route's geometry (attention_kernel.cuh), a
// thread block per (head, batch row, group of query rows) with K and V of the
// head staged by cp.async into padded shared memory (K lands before V, so
// q.k^T runs while V is in flight), a warp per 16 query rows, its 16 x N
// logits in registers, the softmax over the quad with shuffles. Both products
// run on mma.sync m16n8k8 tf32 (f32 accumulate) as 3xTF32: each f32 operand
// x splits into big = rna_tf32(x) and small = rna_tf32(x - big) (x - big is
// exact in f32), and a product issues small.big + big.small + big.big into
// one f32 accumulator, the small terms first. big + small carries 22 of x's
// 24 significant bits, so the three products keep f32-class accuracy where
// one TF32 product keeps about three decimal digits. Operands are split where
// they are used: K and V stay f32 in shared memory (a split copy would double
// it), q's fragments come from device memory one 8-channel step ahead, the
// probabilities are split from the logit registers. The k index of an MMA
// maps to channels (q.k) or keys (p.v) 2t and 2t + 1 of its 8, so that
//   - q's A fragment is one float2 per row from device memory,
//   - K's B fragment is one 8-byte shared load (K rows padded to ld = 8 mod
//     16 floats: the 16 lanes of a half-warp hit 32 distinct banks),
//   - the logit accumulator of an n8 tile (row g, keys 2t and 2t + 1) is the
//     probabilities' A fragment as it lies, with no shuffle,
//   - V's B fragment is two 4-byte shared loads of keys 2t and 2t + 1 (V rows
//     padded to ld = 4 mod 8 floats: 32 distinct banks); V stays key-major.
// A warp issues the three products of 4 (q.k) or 5 (p.v) n-tiles by term, as
// many MMAs apart on one accumulator. D is padded to a multiple of 8 and the
// keys to a multiple of 8 with zeros in shared memory (q's padding read as
// zero); a masked logit is -inf, its probability 0. Copies are 16 bytes where
// D, the strides and the pointers allow, else 4. At ViT-H one 132 KB block of
// 12 warps fits an SM: the loads and stores alone take 0.021 ms, the two
// products ~0.045 each and the softmax ~0.008 (knock-out variants on the
// H100, PERF.md), neither the MMAs nor the split's integer ops near their
// rates: three warps a scheduler do not hide the latencies.
//
// CUDA-core route (the shapes past those limits, e.g. N 300): PR 2's kernel,
// one warp per query row on the f32 CUDA cores, lanes over keys for the
// logits and over channels for p.v, K and V of the head in shared memory.

#pragma once

#include "attention_kernel.cuh"

namespace {

constexpr int TF32_MAX_N = 256;
constexpr int TF32_MAX_D = 128;
constexpr int CORES_THREADS = 256;  // the CUDA-core route's block

// x rounded to tf32 (10 stored mantissa bits), half away from zero, as
// cvt.rna.tf32.f32, as an MMA operand: half of the dropped field added to the
// magnitude bits, which then carry into the exponent as they should. The
// tensor cores read only the top 19 bits of a tf32 operand, so the field is
// left for them to drop (bit-equal on the H100 to cutting it off here, one
// integer op a value fewer).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// big and small tf32 parts of x as MMA operands; big's value is its top 19
// bits
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big & 0xffffe000u));
}

// c (16x8, f32) += a (16x8, tf32, row) . b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four values of an A fragment split
__device__ __forceinline__ void split_a(const float (&x)[4],
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(x[i], big[i], small[i]);
}

// W floats global -> shared (16 or 4 bytes), zeros where !pred
template <int W>
__device__ __forceinline__ void cp_async_w(float* smem, const float* gmem,
                                           bool pred) {
  if constexpr (W == 4) {
    cp_async16(smem, gmem, pred);
  } else {
    const unsigned dst = smem_addr(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(pred ? 4 : 0));
  }
}

// NT: 8-key tiles a row of logits can hold (N <= 8 * NT), a register budget:
// the tiles past the row's end are skipped at run time. W: floats a copy.
template <int NT, int W>
__global__ void __launch_bounds__(NT > 24 ? 256 : ATTN_WARPS * 32)
    attention_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out,
                          int N, int H, int D, long long batch_stride,
                          long long row_stride, float scale) {
  constexpr int G = 4;   // q.k: key n-tiles whose products go by term
  constexpr int GV = 5;  // p.v: channel n-tiles a pass (40 channels)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = (N + 7) / 8, NP = 8 * nt;  // key tiles, padded keys
  const int DP = (D + 7) / 8 * 8;           // padded channels
  const int ldk = DP % 16 ? DP : DP + 8;    // 8 mod 16
  const int ldv = DP + 4;                   // 4 mod 8
  float* Ks = reinterpret_cast<float*>(smem_raw);  // NP x ldk
  float* Vs = Ks + (size_t)NP * ldk;               // NP x ldv

  const int h = blockIdx.x;
  const size_t base = (size_t)blockIdx.y * batch_stride + (size_t)h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (blockIdx.z * (blockDim.x / 32) + warp) * 16;  // first row
  const int g = lane / 4, t = lane % 4;  // fragment row, thread in quad

  // K, then V: rows past N and channels past D zero-filled
  const int chunks = DP / W;
  for (int idx = threadIdx.x; idx < NP * chunks; idx += blockDim.x) {
    const int m = idx / chunks, c = (idx % chunks) * W;
    const bool ok = m < N && c < D;
    cp_async_w<W>(Ks + (size_t)m * ldk + c,
                  ok ? k + base + (size_t)m * row_stride + c : k, ok);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < NP * chunks; idx += blockDim.x) {
    const int m = idx / chunks, c = (idx % chunks) * W;
    const bool ok = m < N && c < D;
    cp_async_w<W>(Vs + (size_t)m * ldv + c,
                  ok ? v + base + (size_t)m * row_stride + c : v, ok);
  }
  cp_async_commit();

  // q's A fragment of channels d0..d0+7: rows g, g + 8 (x[0], x[1]) at
  // channel d0 + 2t, the same rows (x[2], x[3]) at d0 + 2t + 1
  auto load_q = [&](int d0, float (&x)[4]) {
    const int c = d0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + g + 8 * i;
      const float* p = q + base + (size_t)row * row_stride + c;
      if constexpr (W == 4) {  // D % 4 == 0: c < D covers c + 1
        float2 f = make_float2(0.f, 0.f);
        if (row < N && c < D) f = *reinterpret_cast<const float2*>(p);
        x[i] = f.x, x[2 + i] = f.y;
      } else {
        x[i] = row < N && c < D ? p[0] : 0.f;
        x[2 + i] = row < N && c + 1 < D ? p[1] : 0.f;
      }
    }
  };
  const bool active = q0 < N;  // warp-uniform
  float qa[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) load_q(0, qa);
  cp_async_wait<1>();  // this thread's K copies landed
  __syncthreads();     // everyone's

  // s: 16 rows x NP keys of logits, then of probabilities; n-tile j holds
  // keys 8j..8j+7: s[j][0..1] row g, s[j][2..3] row g + 8, keys 8j + 2t
  // and 8j + 2t + 1
  float s[NT][4];
  if (active) {
    // ---- s = q . k^T
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int d0 = 0; d0 < DP; d0 += 8) {
      float qn[4];
      if (d0 + 8 < DP) load_q(d0 + 8, qn);
      uint32_t ab[4], as[4];
      split_a(qa, ab, as);
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += G) {
        if (j0 < nt) {
          uint32_t bb[G][2] = {}, bs[G][2] = {};
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (j0 + u < nt) {
              // key 8(j0 + u) + g, channels d0 + 2t, d0 + 2t + 1
              const float2 f = *reinterpret_cast<const float2*>(
                  Ks + (size_t)(8 * (j0 + u) + g) * ldk + d0 + 2 * t);
              tf32_split(f.x, bb[u][0], bs[u][0]);
              tf32_split(f.y, bb[u][1], bs[u][1]);
            }
          }
#pragma unroll
          for (int u = 0; u < G; ++u)
            if (j0 + u < nt) mma_tf32(s[j0 + u], as, bb[u][0], bb[u][1]);
#pragma unroll
          for (int u = 0; u < G; ++u)
            if (j0 + u < nt) mma_tf32(s[j0 + u], ab, bs[u][0], bs[u][1]);
#pragma unroll
          for (int u = 0; u < G; ++u)
            if (j0 + u < nt) mma_tf32(s[j0 + u], ab, bb[u][0], bb[u][1]);
        }
      }
      if (d0 + 8 < DP) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qn[i];
      }
    }

    // ---- the row softmax in registers, the twin's steps
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = 8 * j + 2 * t + (e & 1) < N;
          const float x = key_ok ? s[j][e] * scale : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], x);
          s[j][e] = x;
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = expf(s[j][e] - mx[e / 2]);
          s[j][e] = ex;
          sum[e / 2] += ex;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e / 2];
      }
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();
  if (!active) return;

  // ---- o = p . v, 40 output channels (GV n-tiles) a pass; the A fragment
  // of key tile j is (s[j][0], s[j][2], s[j][1], s[j][3]): rows g, g + 8 at
  // key 2t, then at key 2t + 1
  const int C = H * D;
  const int ntd = DP / 8;  // channel n-tiles
  for (int n0 = 0; n0 < ntd; n0 += GV) {
    // the probabilities' parts are formed anew for every pass: hoisted
    // out of this loop they would take 192 registers and spill
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(s[j][e]));
    float o[GV][4];
#pragma unroll
    for (int n = 0; n < GV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t pb[4], ps[4];
        split_a(pa, pb, ps);
        const float* vr = Vs + (size_t)(8 * j + 2 * t) * ldv + 8 * n0 + g;
        uint32_t vb[GV][2] = {}, vs[GV][2] = {};
#pragma unroll
        for (int n = 0; n < GV; ++n) {
          if (n0 + n < ntd) {
            // keys 8j + 2t, 8j + 2t + 1; channel 8(n0 + n) + g
            tf32_split(vr[8 * n], vb[n][0], vs[n][0]);
            tf32_split(vr[ldv + 8 * n], vb[n][1], vs[n][1]);
          }
        }
#pragma unroll
        for (int n = 0; n < GV; ++n)
          if (n0 + n < ntd) mma_tf32(o[n], ps, vb[n][0], vb[n][1]);
#pragma unroll
        for (int n = 0; n < GV; ++n)
          if (n0 + n < ntd) mma_tf32(o[n], pb, vs[n][0], vs[n][1]);
#pragma unroll
        for (int n = 0; n < GV; ++n)
          if (n0 + n < ntd) mma_tf32(o[n], pb, vb[n][0], vb[n][1]);
      }
    }
#pragma unroll
    for (int n = 0; n < GV; ++n) {
      const int d = 8 * (n0 + n) + 2 * t;
      if (n0 + n < ntd && d < D) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + g + 8 * r;
          if (row < N) {
            float* dst = out + ((size_t)blockIdx.y * N + row) * C +
                         (size_t)h * D + d;
            if (D % 2 == 0) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(o[n][2 * r], o[n][2 * r + 1]);
            } else {
              dst[0] = o[n][2 * r];
              if (d + 1 < D) dst[1] = o[n][2 * r + 1];
            }
          }
        }
      }
    }
  }
}

size_t tf32_smem(int N, int D) {
  const int NP = (N + 7) / 8 * 8, DP = (D + 7) / 8 * 8;
  return sizeof(float) * (size_t)NP * ((DP % 16 ? DP : DP + 8) + DP + 4);
}

template <int NT, int W>
int launch_tf32_nt(const float* q, const float* k, const float* v, float* out,
                   int B, int N, int H, int D, long long batch_stride,
                   long long row_stride, float scale, cudaStream_t stream) {
  const int tiles = (N + 15) / 16;
  // NT = 32 takes more registers: __launch_bounds__ allows it 8 warps
  const int warps = min(tiles, NT > 24 ? 8 : ATTN_WARPS);
  const size_t smem = tf32_smem(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_tf32_kernel<NT, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (tiles + warps - 1) / warps);
  attention_tf32_kernel<NT, W><<<grid, warps * 32, smem, stream>>>(
      q, k, v, out, N, H, D, batch_stride, row_stride, scale);
  return (int)cudaGetLastError();
}

// One launch of the tensor-core route; cudaErrorInvalidValue past its limits
// (the wrapper sends those shapes to the CUDA-core route or refuses them)
int launch_tf32(const float* q, const float* k, const float* v, float* out,
                int B, int N, int H, int D, long long batch_stride,
                long long row_stride, float scale, cudaStream_t stream) {
  if (N < 1 || N > TF32_MAX_N || D < 1 || D > TF32_MAX_D)
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool w4 = D % 4 == 0 && batch_stride % 4 == 0 &&
                  row_stride % 4 == 0 && aligned(q) && aligned(k) &&
                  aligned(v);
  if (N <= 192)
    return w4 ? launch_tf32_nt<24, 4>(q, k, v, out, B, N, H, D, batch_stride,
                                      row_stride, scale, stream)
              : launch_tf32_nt<24, 1>(q, k, v, out, B, N, H, D, batch_stride,
                                      row_stride, scale, stream);
  return w4 ? launch_tf32_nt<32, 4>(q, k, v, out, B, N, H, D, batch_stride,
                                    row_stride, scale, stream)
            : launch_tf32_nt<32, 1>(q, k, v, out, B, N, H, D, batch_stride,
                                    row_stride, scale, stream);
}

// ------------------------------------------------------ CUDA-core route
__global__ void __launch_bounds__(CORES_THREADS) attention_f32_cores_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int N, int H, int D,
    long long batch_stride, long long row_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * D;
  const int KD = D + 1;  // odd rows: lanes reading different keys, other banks
  const int nwarps = CORES_THREADS / 32;
  float* Ks = reinterpret_cast<float*>(smem_raw);  // N x KD
  float* Vs = Ks + (size_t)N * KD;                 // N x D
  float* qbuf = Vs + (size_t)N * D;                // nwarps x D
  float* pbuf = qbuf + nwarps * D;                 // nwarps x N

  const size_t base =
      (size_t)blockIdx.y * batch_stride + (size_t)blockIdx.x * D;
  for (int idx = threadIdx.x; idx < N * D; idx += CORES_THREADS) {
    const int m = idx / D, d = idx % D;
    Ks[(size_t)m * KD + d] = k[base + (size_t)m * row_stride + d];
    Vs[(size_t)m * D + d] = v[base + (size_t)m * row_stride + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = qbuf + warp * D;
  float* p = pbuf + warp * N;
  for (int n = warp; n < N; n += nwarps) {
    for (int d = lane; d < D; d += 32)
      qs[d] = q[base + (size_t)n * row_stride + d];
    __syncwarp();
    float mx = -INFINITY;
    for (int m = lane; m < N; m += 32) {
      const float* krow = Ks + (size_t)m * KD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[d], krow[d], s);
      s = s * scale;
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
    for (int m = lane; m < N; m += 32) p[m] = p[m] / sum;
    __syncwarp();
    const size_t orow =
        ((size_t)blockIdx.y * N + n) * C + (size_t)blockIdx.x * D;
    for (int d = lane; d < D; d += 32) {
      float o = 0.f;
      for (int m = 0; m < N; ++m) o = fmaf(p[m], Vs[(size_t)m * D + d], o);
      out[orow + d] = o;
    }
    __syncwarp();
  }
}

int launch_f32_cores(const float* q, const float* k, const float* v,
                     float* out, int B, int N, int H, int D,
                     long long batch_stride, long long row_stride, float scale,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)N * (2 * D + 1) +
                                       (size_t)(CORES_THREADS / 32) * (D + N));
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_cores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_f32_cores_kernel<<<dim3(H, B), CORES_THREADS, smem, stream>>>(
      q, k, v, out, N, H, D, batch_stride, row_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace
