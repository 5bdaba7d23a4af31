// The int8 tensor-core GEMM main loop of the W8A8 blocks, shared by the
// serving kernel (vit_block_int8.cu) and its knock-out variants
// (vit_block_ablation.cu). The epilogue is a type: `ep.store(acc, gm, gn,
// idx)` is inlined into the accumulator loop, so each source pays only for
// the epilogues it instantiates.

#pragma once

#include "common.cuh"

namespace {

// D (16x8, s32) += A (16x32, s8, row) . B (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// One 128 x 128 output tile per thread block (blockIdx.x over N, blockIdx.y
// over M); `smem` is the block's GEMM_SMEM bytes of dynamic shared memory.
template <typename Epi>
__device__ __forceinline__ void gemm_i8_tile(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W, const Epi& ep,
    int M, int N, int K, unsigned char* smem) {
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // STAGES x BM x LDS
  int8_t* Bs = As + STAGES * BM * LDS;           // STAGES x BN x LDS

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
        if (gm < M && gn < N) ep.store(acc[i][j][r], gm, gn, (size_t)gm * N + gn);
      }
    }
  }
}

}  // namespace
