// The Hopper GEMM main loop of the port's ViT blocks, one template for two
// element types: out[M, N] = epilogue(A[M, K] . W[N, K]^T) with A row-major
// and W in nn.Linear's (out, in) layout, both K-major, as wgmma takes them.
//   bf16 x bf16 -> f32 (wgmma m64n128k16): the bf16 block's four GEMMs
//     (vit_block.cu, K3 and K4's forward);
//   s8 x s8 -> s32 (wgmma m64n128k32): the W8A8 blocks' GEMMs with their
//     dequantising epilogues (vit_block_int8.cu, K5 and K6) and the
//     knock-out epilogues of K8 (vit_block_ablation.cu).
// The epilogue is a type: `ep.store2<EDGE>(v0, v1, gm, gn, two)` finishes
// the two adjacent outputs (gm, gn) and (gm, gn + 1) (the second only if
// `two`; EDGE = false when both exist and are aligned, and
// `ep.aligned_pairs()` says whether an inner tile's are), so each source
// pays only for the epilogues it instantiates. An epilogue may ask for
// SCRATCH_BYTES of shared memory, which the epilogue warps fill once a
// launch through `ep.prepare(scratch, thread, threads)` (a table).
//
// Replaces the dense products of hands_tpu/ops/vit_block_pallas.py's block
// kernels (matmul_bf16 :154 in _vit_block_kernel, pl.pallas_call :414;
// _int8_dot :203 and idot :326 in the int8 bodies, :536 and :658) and of
// scripts/vith_int8_ablation.py's _ablation_kernel (:194), which the TPU
// keeps on its 128 x 128 matrix unit with whole weights in VMEM.
//
// What bounds it on this card: a ViT-H block's four GEMMs do 2*M*19.7M
// operations over 39 MB of bf16 (19.7 MB of int8) weights; from ~300 token
// rows on (3072 at 8 images) that is the tensor cores' time, 989 TFLOP/s
// bf16 and 1,979 TOP/s int8: 0.122 ms and 0.061 ms per block at 3072 rows.
// Only wgmma reaches that rate. Behind the products, the epilogues: the
// exact GELU of the MLP's first GEMM costs ~74 instructions an output
// (erfcf, the bf16 roundings) without vit_block.cu's erfc table, more than
// the tile's products take.
// What the design does about it:
//   - one thread block per SM walks 128 x 128 output tiles (a persistent
//     grid); one producer warp issues TMA loads of A and W tiles (128-byte
//     rows: 64 bf16 or 128 int8 of K, in the 128-byte swizzle that wgmma
//     reads without bank conflicts) into a ring of four stages with a
//     "full" and an "empty" mbarrier each, running ahead across tiles;
//   - two MMA warpgroups own 64 rows each and run wgmma.mma_async from
//     shared-memory descriptors, keeping one stage's products in flight
//     while they wait for the next (wgmma.wait_group 1) and releasing a
//     stage as soon as its products have read it;
//   - the MMA warpgroups hand a finished tile's accumulators to 11 epilogue
//     warps through shared memory (acc_full / acc_empty) and go on with the
//     next tile, so that the epilogue of one tile runs while the tensor
//     cores work on the next; the epilogue warps store rows of 64 adjacent
//     outputs (coalesced pairs), without a branch inside inner tiles;
//   - TMA zero-fills the ragged M, N and K edges; only the stores are
//     guarded;
//   - registers: ptxas compiles every warp within the launch's register
//     count, 96 for 20 warps (5 in each of the SM's four register
//     partitions); the 64-accumulator wgmma needs 90, so 8 MMA + 11
//     epilogue + 1 producer warps is the largest block (setmaxnreg cannot
//     give the MMA warps more);
//   - the tile is fixed at 128 x 128 (the launcher's rule): at M = 3072 the
//     ViT-H shapes give 720 / 240 / 960 / 240 tiles (qkv, proj, fc1, fc2)
//     on 132 SMs, ~9% of the last round idle on the narrow shapes, as with
//     128 x 256 tiles (360 / 120 / 480 / 120), which need 128 accumulators
//     a thread and leave no registers for epilogue warps.
// The host encodes the two tensor maps per launch with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that
// the library needs no -lcuda. TMA needs 16-byte aligned bases and row
// strides (K % 8 bf16, K % 16 int8): the wrappers check both.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int GEMM_BM = 128;  // two MMA warpgroups of 64 rows
constexpr int GEMM_BN = 128;  // one m64n128 product per k-slice
constexpr int GEMM_STAGES = 4;
constexpr int MMA_WARPS = 8;  // warps 0-7: two MMA warpgroups
constexpr int EPI_WARPS = 11;  // warps 8-18: the epilogue
constexpr int GEMM_THREADS = 32 * (MMA_WARPS + EPI_WARPS + 1);  // + producer
constexpr int ROW_BYTES = 128;  // one K tile row, one swizzle span
constexpr int A_TILE_BYTES = GEMM_BM * ROW_BYTES;  // 16 KB
constexpr int W_TILE_BYTES = GEMM_BN * ROW_BYTES;  // 16 KB
constexpr int STAGE_BYTES = A_TILE_BYTES + W_TILE_BYTES;
// a tile's accumulators on their way to the epilogue warps: 128 rows of
// 128 32-bit values, padded by 8 (a warp's pair stores from the MMA
// fragments and its row reads both take the minimal two wavefronts)
constexpr int ACC_STRIDE = GEMM_BN + 8;
constexpr int ACC_BYTES = GEMM_BM * ACC_STRIDE * 4;  // 69,632 B
// stages (1024-byte aligned for the swizzle), the accumulators, then the
// mbarriers: full and empty per stage, acc_full and acc_empty
constexpr int NUM_BARRIERS = 2 * GEMM_STAGES + 2;
constexpr size_t GEMM_SMEM = 1024 + (size_t)GEMM_STAGES * STAGE_BYTES +
                             ACC_BYTES + NUM_BARRIERS * 8;  // 201,808 B

template <typename T>
struct GemmType;

template <>
struct GemmType<bf16> {
  typedef float Acc;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // D (64 x 128, f32) += A (64 x 16) . B (128 x 16)^T, both K-major
  static __device__ __forceinline__ void mma(
      float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct GemmType<int8_t> {
  typedef int Acc;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // D (64 x 128, s32) += A (64 x 32) . B (128 x 32)^T, both K-major
  static __device__ __forceinline__ void mma(
      int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a phase that
// never completes (a lost arrival) traps after ~2^34 clocks (~9 s) instead
// of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// the box at (x = k, y = row) of `map` -> shared memory at `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: rows in groups of 8 (1024 bytes apart, the stride byte offset);
// the leading byte offset is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// keeps the compiler from moving accumulators across the asynchronous MMAs
__device__ __forceinline__ void fence_reg(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void fence_reg(int& v) {
  asm volatile("" : "+r"(v)::"memory");
}

template <typename Acc>
__device__ __forceinline__ void fence_acc(Acc (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(d[i]);
}

template <typename Acc>
struct Pair;
template <>
struct Pair<float> {
  typedef float2 type;
};
template <>
struct Pair<int> {
  typedef int2 type;
};

// The epilogue warps' share of one tile: warp e takes rows e, e + EPI_WARPS,
// ..., a lane the column pairs 2*lane and 64 + 2*lane of each, so that a warp
// stores 64 adjacent outputs at a time. EDGE: guard the rows and columns
// past the output and pairs that are not aligned (else the tile is inside
// and its pairs aligned, and the loop has no branch).
template <bool EDGE, typename Epi, typename Acc>
__device__ __forceinline__ void epilogue_tile(const Epi& ep, const Acc* acc,
                                              int e, int lane, int m0, int n0,
                                              int M, int N) {
  typedef typename Pair<Acc>::type Acc2;
#pragma unroll 4
  for (int r = e; r < GEMM_BM; r += EPI_WARPS) {
    const int gm = m0 + r;
    if (EDGE && gm >= M) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * h + 2 * lane, gn = n0 + c;
      if (EDGE && gn >= N) continue;
      const Acc2 v = *reinterpret_cast<const Acc2*>(acc + r * ACC_STRIDE + c);
      ep.template store2<EDGE>(v.x, v.y, gm, gn, !EDGE || gn + 1 < N);
    }
  }
}

// A persistent grid: block b takes output tiles b, b + gridDim.x, ... of
// the (M / 128) x (N / 128) grid, N fastest. Warp roles:
//   warp 19 (producer): one thread keeps the ring of stages full with TMA
//     loads, across tiles;
//   warps 0-7 (two MMA warpgroups): rows 0-63 and 64-127 of a tile on
//     wgmma, then the accumulators into shared memory (acc_full) once the
//     epilogue warps have read the last tile's (acc_empty);
//   warps 8-18 (epilogue): apply ep to a tile while the MMA warpgroups run
//     the next one's main loop.
template <typename T, typename Epi>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_w, const Epi ep,
                     int M, int N, int K) {
  typedef typename GemmType<T>::Acc Acc;
  constexpr int K_TILE = ROW_BYTES / (int)sizeof(T);  // 64 bf16, 128 int8
  extern __shared__ unsigned char gemm_smem_raw[];
  const uint32_t base = (smem_u32(gemm_smem_raw) + 1023) & ~1023u;
  Acc* acc_smem = reinterpret_cast<Acc*>(
      gemm_smem_raw + (base - smem_u32(gemm_smem_raw)) +
      GEMM_STAGES * STAGE_BYTES);
  const uint32_t bars = base + GEMM_STAGES * STAGE_BYTES + ACC_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GEMM_STAGES + s); };
  const uint32_t acc_full = bars + 16 * GEMM_STAGES;
  const uint32_t acc_empty = acc_full + 8;
  const int k_tiles = (K + K_TILE - 1) / K_TILE;
  const int tiles_n = (N + GEMM_BN - 1) / GEMM_BN;
  const int tiles = tiles_n * ((M + GEMM_BM - 1) / GEMM_BM);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 2);  // one arrival per MMA warpgroup
    }
    mbar_init(acc_full, 32 * MMA_WARPS);
    mbar_init(acc_empty, 32 * EPI_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == MMA_WARPS + EPI_WARPS) {
    // ---- producer
    if (lane == 0) {
      int g = 0;  // k-steps issued by this block, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * GEMM_BM, n0 = t % tiles_n * GEMM_BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++g) {
          const int s = g % GEMM_STAGES;
          mbar_wait(empty(s), ((g / GEMM_STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);  // zero-filled bytes count
          const uint32_t a = base + s * STAGE_BYTES;
          tma_load(a, &tm_a, full(s), kt * K_TILE, m0);
          tma_load(a + A_TILE_BYTES, &tm_w, full(s), kt * K_TILE, n0);
        }
      }
    }
  } else if (warp < MMA_WARPS) {
    // ---- MMA warpgroup cw: rows 64*cw .. 64*cw + 63 of each tile
    const int cw = warp / 4;
    int g = 0;
    for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
      Acc acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % GEMM_STAGES;
        mbar_wait(full(s), (g / GEMM_STAGES) & 1);
        const uint32_t a = base + s * STAGE_BYTES + cw * 64 * ROW_BYTES;
        const uint32_t w = base + s * STAGE_BYTES + A_TILE_BYTES;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < ROW_BYTES / 32; ++kk)  // 32 bytes of K a step
          GemmType<T>::mma(acc, smem_desc(a + 32 * kk),
                           smem_desc(w + 32 * kk));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        // the products of the step before are done: hand its slot back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc);
        if (kt > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(empty((g - 1) % GEMM_STAGES));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty((g - 1) % GEMM_STAGES));

      // acc[4j + q] is row 16*(warp%4) + lane/4 + 8*(q/2), column 8j +
      // 2*(lane%4) + q%2 of this warpgroup's 64 rows
      mbar_wait(acc_empty, (it & 1) ^ 1);
      Acc* rows = acc_smem + (cw * 64 + (warp % 4) * 16 + lane / 4) *
                                 ACC_STRIDE + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          typedef typename Pair<Acc>::type Acc2;
          Acc2 v;
          v.x = acc[4 * j + 2 * r];
          v.y = acc[4 * j + 2 * r + 1];
          *reinterpret_cast<Acc2*>(rows + 8 * r * ACC_STRIDE + 8 * j) = v;
        }
      mbar_arrive(acc_full);
    }
  } else {
    // ---- epilogue warps: the epilogue's tables (Epi::SCRATCH_BYTES past
    // the barriers) are filled while the first tile's products run
    const int e = warp - MMA_WARPS;
    Epi lep = ep;
    if (Epi::SCRATCH_BYTES > 0) {
      lep.prepare(gemm_smem_raw + (bars + 8 * NUM_BARRIERS -
                                   smem_u32(gemm_smem_raw)),
                  threadIdx.x - 32 * MMA_WARPS, 32 * EPI_WARPS);
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * EPI_WARPS) : "memory");
    }
    for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
      const int m0 = t / tiles_n * GEMM_BM, n0 = t % tiles_n * GEMM_BN;
      mbar_wait(acc_full, it & 1);
      if (m0 + GEMM_BM <= M && n0 + GEMM_BN <= N && lep.aligned_pairs())
        epilogue_tile<false>(lep, acc_smem, e, lane, m0, n0, M, N);
      else
        epilogue_tile<true>(lep, acc_smem, e, lane, m0, n0, M, N);
      mbar_arrive(acc_empty);
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, K) K-major operand -> boxes of box_rows x 128 bytes, 128-byte
// swizzle, zero fill past the edges
template <typename T>
bool encode_operand(CUtensorMap* map, const T* p, int rows, int K,
                    int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / sizeof(T)),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, GemmType<T>::TMA, 2, const_cast<T*>(p), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the GEMM: one block per SM (at most one per tile), each
// walking its share of the 128 x 128 output tiles. Returns the cudaError_t
// of the launch.
template <typename T, typename Epi>
int launch_gemm(const T* a, const T* w, const Epi& ep, int M, int N, int K,
                cudaStream_t stream) {
  CUtensorMap tm_a, tm_w;
  if (!encode_operand(&tm_a, a, M, K, GEMM_BM) ||
      !encode_operand(&tm_w, w, N, K, GEMM_BN))
    return (int)cudaErrorInvalidValue;
  // the SM count and the shared-memory limit, once per device (a launch
  // of a few tens of microseconds should not pay driver queries)
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES];
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const size_t smem = GEMM_SMEM + Epi::SCRATCH_BYTES;
  if (sms_of[device] == 0) {
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gemm_sm90_kernel<T, Epi>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const int tiles =
      ((N + GEMM_BN - 1) / GEMM_BN) * ((M + GEMM_BM - 1) / GEMM_BM);
  gemm_sm90_kernel<T, Epi><<<tiles < sms ? tiles : sms, GEMM_THREADS, smem,
                             stream>>>(tm_a, tm_w, ep, M, N, K);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- pairs of adjacent values
// p[0] and, if `two`, p[1]: one access where the pair is aligned. EDGE =
// false: the caller knows that both exist and are aligned.
template <bool EDGE>
__device__ __forceinline__ float2 pair_load(const float* p, bool two) {
  if (!EDGE || (two && !(reinterpret_cast<uintptr_t>(p) & 7)))
    return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], two ? p[1] : 0.f);
}

template <bool EDGE>
__device__ __forceinline__ float2 pair_load(const bf16* p, bool two) {
  if (!EDGE || (two && !(reinterpret_cast<uintptr_t>(p) & 3)))
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]),
                     two ? __bfloat162float(p[1]) : 0.f);
}

template <bool EDGE>
__device__ __forceinline__ void pair_store(float* p, float v0, float v1,
                                           bool two) {
  if (!EDGE || (two && !(reinterpret_cast<uintptr_t>(p) & 7))) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

// rounds each value to bf16 (round to nearest even)
template <bool EDGE>
__device__ __forceinline__ void pair_store(bf16* p, float v0, float v1,
                                           bool two) {
  if (!EDGE || (two && !(reinterpret_cast<uintptr_t>(p) & 3))) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (two) p[1] = __float2bfloat16_rn(v1);
  }
}

template <bool EDGE>
__device__ __forceinline__ void pair_store(int8_t* p, int8_t v0, int8_t v1,
                                           bool two) {
  if (!EDGE || (two && !(reinterpret_cast<uintptr_t>(p) & 1))) {
    *reinterpret_cast<uint16_t*>(p) =
        (uint16_t)((uint8_t)v0 | (uint16_t)(uint8_t)v1 << 8);
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

}  // namespace
