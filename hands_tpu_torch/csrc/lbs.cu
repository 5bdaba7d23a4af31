// Fused linear blend skinning for NVIDIA Hopper (sm_90a), forward and
// gradient: per vertex, blend the 16 joint transforms with the vertex's
// skinning weights and apply the blend to [v, 1]; the per-vertex transform
// tensor T (B, V, 4, 4) never reaches device memory, in either direction.
// Plain C interface, built with nvcc and loaded with ctypes by
// hands_tpu_torch/ops/mano_lbs.py.
//
// Replaces: hands_tpu/ops/mano_pallas.py:64 lbs_apply (pl.pallas_call at :90,
// body _lbs_kernel at :41). The TPU kernel pads the vertices to 896 and the
// batch to 8 and contracts through a (16, 4) group-sum matrix, because Mosaic
// cannot reshape the lane dimension; none of that is the function, and none
// of it is here. The TPU kernel has no backward (JAX differentiates the
// einsum at hands_tpu/ops/mano.py:326-328); lbs_apply_bwd computes the
// gradient of the same function.
//
//   forward   out[b,v,r] = sum_c T[b,v,r,c] vh[b,v,c],  r < 3
//             T[b,v]     = sum_j W[v,j] A[b,j],          vh = [v, 1]
//   backward  dv[b,v,c]  = sum_r T[b,v,r,c] g[b,v,r],    c < 3
//             dA[b,j,r,c] = sum_v W[v,j] g[b,v,r] vh[b,v,c] for r < 3, 0 for
//             r = 3
//
// What bounds it on this card: per (sample, vertex) the forward reads 12 B,
// writes 12 B and does 16 * 12 FMAs for the blend plus 9 for the apply, 402
// FLOP on 24 B, and the backward about 700 FLOP on 36 B: bytes and
// operations bound both about equally, at 0.4 (forward) and 0.6 us
// (backward) for a batch of 64 hands. That is below the time a launch
// takes inside a CUDA graph, so the design is held to the measured floor
// of an empty launch and of a pass that only moves the forward's bytes
// (lbs_empty, lbs_copy; chip_smoke.lbs_alone), not to the bound.
//
// Forward (lbs_kernel): a (vertex tile, sample) grid of 128 threads, two
// vertices a thread. Every global load is started before the one barrier:
// the vertices' weights (four 16-byte loads each) and coordinates, and the
// sample's transforms, rows 0..2 of each joint staged as 48 16-byte rows,
// one a thread. After the barrier each row is read once from shared memory
// (all lanes read the same address) for both vertices: the broadcast reads
// of A, not the bytes, are what the design spends, and two vertices a
// thread halve them. The blend sums j = 0..15 into 12 accumulators with f32
// FMAs in the order of the first design (a thread per vertex, A staged a
// float at a time before the vertex's loads), so it is bit-equal to it; the
// contraction depth is 16 and this is geometry: no TF32. The designs it was
// timed against are in PERF.md.
//
// Backward (lbs_bwd_kernel), one launch of two blocks a sample, one for dA
// and one for dv, each staging the sample's inputs it reads in shared
// memory by one round of asynchronous copies in their own layout (a
// transposed W, scattered 16-byte writes that collide in the banks, took
// longer to stage than the rest of the kernel ran). dv per vertex with the
// forward's blend; dA's 192 entries summed over 32 vertex slices in vertex
// order, then over the slices in a fixed butterfly. No atomics: two runs
// are bit-equal. It takes V <= 1024 (MANO's 778: 69 KB of shared memory).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int LBS_THREADS = 128;
constexpr int LBS_JOINTS = 16;
constexpr int LBS_VERTS_A_THREAD = 2;
constexpr int T_ENTRIES = 12;  // rows 0..2 of a 4x4 transform
constexpr int BWD_THREADS = 256;  // two blocks a sample: dA, dv
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_V = 1024;
constexpr int MAX_DEVICES = 64;
constexpr int DA_ENTRIES = LBS_JOINTS * T_ENTRIES;  // 192 a sample
constexpr int DA_JOINTS_A_THREAD = 2;
constexpr int DA_GROUPS = LBS_JOINTS / DA_JOINTS_A_THREAD;  // 8 joint pairs
constexpr int DA_SLICES = BWD_THREADS / DA_GROUPS;  // 32 vertex slices
constexpr int DA_PARTIALS = DA_JOINTS_A_THREAD * T_ENTRIES;  // 24 a thread
constexpr int DA_STRIDE = DA_SLICES + 1;  // slice partials of one entry
constexpr int DA_CHAINS = DA_ENTRIES / BWD_WARPS;  // entries a warp reduces
constexpr int A_ROWS = LBS_JOINTS * 3;  // staged 16-byte rows of A

static_assert(DA_SLICES == 32, "a lane a slice in the reduction");
static_assert(DA_CHAINS <= 32, "a lane stores each entry of its warp");

// floats of the backward's dynamic shared memory for V vertices: the rows of
// A, then W (V rows of 16), g and v_posed; the dA block's slice partials
// later overwrite W
__host__ __device__ constexpr int bwd_smem_floats(int V) {
  return 4 * A_ROWS + (22 * V > DA_ENTRIES * DA_STRIDE
                           ? 22 * V : DA_ENTRIES * DA_STRIDE);
}

__device__ __forceinline__ void load_weights(const float* __restrict__ weights,
                                             int v, float w[LBS_JOINTS]) {
  const float4* w4 = reinterpret_cast<const float4*>(weights) + (size_t)v * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = w4[q];
    w[4 * q] = t.x; w[4 * q + 1] = t.y; w[4 * q + 2] = t.z; w[4 * q + 3] = t.w;
  }
}

// sA[3 j + r] = row r < 3 of sample b's joint j, one 16-byte load a thread
__device__ __forceinline__ void stage_rows(const float* __restrict__ A, int b,
                                           float4* sA) {
  if (threadIdx.x < LBS_JOINTS * 3) {
    const float4* Ab = reinterpret_cast<const float4*>(A) + (size_t)b * 64;
    sA[threadIdx.x] = Ab[(threadIdx.x / 3) * 4 + threadIdx.x % 3];
  }
}

// T[m][e] = sum_j w[m][j] A_j[e] for e = 4 r + c, r < 3, for M vertices, in
// j order; each row of A is read once for the M vertices. Row r of joint j
// is rows[3 j + r] (stage_rows).
template <int M>
__device__ __forceinline__ void blend(const float w[M][LBS_JOINTS],
                                      const float4* rows,
                                      float T[M][T_ENTRIES]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < T_ENTRIES; ++e) T[m][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < LBS_JOINTS; ++j) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float4 a = rows[3 * j + r];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        T[m][4 * r] = fmaf(w[m][j], a.x, T[m][4 * r]);
        T[m][4 * r + 1] = fmaf(w[m][j], a.y, T[m][4 * r + 1]);
        T[m][4 * r + 2] = fmaf(w[m][j], a.z, T[m][4 * r + 2]);
        T[m][4 * r + 3] = fmaf(w[m][j], a.w, T[m][4 * r + 3]);
      }
    }
  }
}

__device__ __forceinline__ float apply_row(const float T[T_ENTRIES], int r,
                                           float x, float y, float z) {
  return fmaf(T[4 * r], x, fmaf(T[4 * r + 1], y,
                                fmaf(T[4 * r + 2], z, T[4 * r + 3])));
}

// ---- forward

// A (vertex tile, sample) grid; a thread takes M vertices (v, v + 128, ...).
// Every global load is started before the one barrier: the vertices' weights
// and coordinates and the sample's transforms (one 16-byte row a thread),
// staged and read back as 16-byte rows that all lanes share.
__global__ void __launch_bounds__(LBS_THREADS)
lbs_kernel(const float* __restrict__ v_posed,   // (B, V, 3)
           const float* __restrict__ weights,   // (V, 16)
           const float* __restrict__ A,         // (B, 16, 4, 4)
           float* __restrict__ out,             // (B, V, 3)
           int V) {
  constexpr int M = LBS_VERTS_A_THREAD;
  __shared__ float4 sA[LBS_JOINTS * 3];
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * LBS_THREADS * M + threadIdx.x;
  float w[M][LBS_JOINTS], x[M], y[M], z[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int v = v0 + m * LBS_THREADS;
    if (v < V) {
      load_weights(weights, v, w[m]);
      const float* vp = v_posed + ((size_t)b * V + v) * 3;
      x[m] = vp[0]; y[m] = vp[1]; z[m] = vp[2];
    } else {
#pragma unroll
      for (int j = 0; j < LBS_JOINTS; ++j) w[m][j] = 0.f;
      x[m] = y[m] = z[m] = 0.f;
    }
  }
  stage_rows(A, b, sA);
  __syncthreads();
  float T[M][T_ENTRIES];
  blend<M>(w, sA, T);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int v = v0 + m * LBS_THREADS;
    if (v < V) {
      float* o = out + ((size_t)b * V + v) * 3;
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = apply_row(T[m], r, x[m], y[m], z[m]);
    }
  }
}

// ---- the floor: K1's grid with no body, and a pass that moves its bytes

__global__ void __launch_bounds__(LBS_THREADS) lbs_empty_kernel() {}

__global__ void __launch_bounds__(LBS_THREADS)
lbs_copy_kernel(const float* __restrict__ v_posed, float* __restrict__ out,
                int V) {
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * LBS_THREADS * LBS_VERTS_A_THREAD + threadIdx.x;
#pragma unroll
  for (int m = 0; m < LBS_VERTS_A_THREAD; ++m) {
    const int v = v0 + m * LBS_THREADS;
    if (v < V) {
      const float* vp = v_posed + ((size_t)b * V + v) * 3;
      float* o = out + ((size_t)b * V + v) * 3;
      const float x = vp[0], y = vp[1], z = vp[2];
      o[0] = x; o[1] = y; o[2] = z;
    }
  }
}

// ---- backward

// Two blocks of 8 warps a sample, side by side: 2 b computes dA, 2 b + 1 dv.
// Each stages what it reads in one round of asynchronous copies, in the
// layout of device memory: W and g, and v_posed (dA) or the rows of A (dv).
// dA: thread t sums the joints 2 q, 2 q + 1 (q = t % 8) over the vertices
// s, s + 32, ... (s = t / 8) in order, 24 partials a thread (a warp reads 4
// whole rows of W: no bank conflicts); the partials replace W, and warp w
// reduces the 24 entries w, w + 8, ...: lane l holds slice l's partial and
// the lanes add theirs in a fixed butterfly, the 24 chains interleaved.
// dv: every thread takes the vertices t, t + 256, ... with the forward's
// blend. Fully unrolled, the thread takes ~220 registers, one block an SM;
// capped at 128 (two blocks an SM) it spilled or, with the blend's joint
// loop rolled up, ran slower at every batch size tried.
__global__ void __launch_bounds__(BWD_THREADS)
lbs_bwd_kernel(const float* __restrict__ v_posed,  // (B, V, 3)
               const float* __restrict__ weights,  // (V, 16)
               const float* __restrict__ A,        // (B, 16, 4, 4)
               const float* __restrict__ g,        // (B, V, 3) d out
               float* __restrict__ dv,             // (B, V, 3)
               float* __restrict__ dA,             // (B, 16, 4, 4)
               int V) {
  extern __shared__ float4 smem[];
  float4* sA = smem;
  float4* sW = smem + A_ROWS;
  float* sg = reinterpret_cast<float*>(sW + 4 * V);
  float* sv = sg + 3 * V;
  const int b = blockIdx.x >> 1, t = threadIdx.x;
  const bool dv_block = blockIdx.x & 1;
  const float* gb = g + (size_t)b * V * 3;
  const float* vb = v_posed + (size_t)b * V * 3;
  if (dv_block && t < A_ROWS)
    __pipeline_memcpy_async(
        &sA[t], reinterpret_cast<const float4*>(A) + (size_t)b * 64 +
                    (t / 3) * 4 + t % 3, 16);
  const float4* w4 = reinterpret_cast<const float4*>(weights);
  for (int i = t; i < 4 * V; i += BWD_THREADS)
    __pipeline_memcpy_async(&sW[i], &w4[i], 16);
  for (int i = t; i < 3 * V; i += BWD_THREADS) {
    __pipeline_memcpy_async(&sg[i], &gb[i], 4);
    if (!dv_block) __pipeline_memcpy_async(&sv[i], &vb[i], 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (dv_block) {
    for (int v = t; v < V; v += BWD_THREADS) {
      float w[1][LBS_JOINTS];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 c = sW[4 * v + k];
        w[0][4 * k] = c.x; w[0][4 * k + 1] = c.y;
        w[0][4 * k + 2] = c.z; w[0][4 * k + 3] = c.w;
      }
      float T[1][T_ENTRIES];  // the forward's blend, in its order
      blend<1>(w, sA, T);
      const float g0 = sg[3 * v], g1 = sg[3 * v + 1], g2 = sg[3 * v + 2];
      float* d = dv + ((size_t)b * V + v) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        d[c] = fmaf(T[0][8 + c], g2, fmaf(T[0][4 + c], g1, T[0][c] * g0));
    }
    return;
  }

  const int q = t % DA_GROUPS, slice = t / DA_GROUPS;
  const float2* sW2 = reinterpret_cast<const float2*>(sW);
  float acc[DA_PARTIALS];
#pragma unroll
  for (int a = 0; a < DA_PARTIALS; ++a) acc[a] = 0.f;
#pragma unroll 2
  for (int v = slice; v < V; v += DA_SLICES) {
    const float2 wq = sW2[8 * v + q];
    const float g0 = sg[3 * v], g1 = sg[3 * v + 1], g2 = sg[3 * v + 2];
    const float x = sv[3 * v], y = sv[3 * v + 1], z = sv[3 * v + 2];
    // d out / d T[r][c] = g_r vh_c, rounded as the twin's autograd rounds it
    const float p[T_ENTRIES] = {g0 * x, g0 * y, g0 * z, g0,
                                g1 * x, g1 * y, g1 * z, g1,
                                g2 * x, g2 * y, g2 * z, g2};
#pragma unroll
    for (int e = 0; e < T_ENTRIES; ++e) {
      acc[e] = fmaf(wq.x, p[e], acc[e]);
      acc[T_ENTRIES + e] = fmaf(wq.y, p[e], acc[T_ENTRIES + e]);
    }
  }
  __syncthreads();  // every thread has read W
  // entry o = 12 j + e of the sample, j = 2 q + jj: this thread's are
  // 24 q .. 24 q + 23
  float* part = reinterpret_cast<float*>(sW);
#pragma unroll
  for (int a = 0; a < DA_PARTIALS; ++a)
    part[(q * DA_PARTIALS + a) * DA_STRIDE + slice] = acc[a];
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  float s[DA_CHAINS];
#pragma unroll
  for (int k = 0; k < DA_CHAINS; ++k)
    s[k] = part[(warp + BWD_WARPS * k) * DA_STRIDE + lane];
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
    for (int k = 0; k < DA_CHAINS; ++k)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], h);
  }
  float* dAb = dA + (size_t)b * LBS_JOINTS * 16;
  if (lane < DA_CHAINS) {  // lane k stores entry warp + 8 k
    float mine = s[0];
#pragma unroll
    for (int k = 1; k < DA_CHAINS; ++k) mine = lane == k ? s[k] : mine;
    const int o = warp + BWD_WARPS * lane;
    dAb[(o / T_ENTRIES) * 16 + o % T_ENTRIES] = mine;
  }
  if (t < LBS_JOINTS * 4)  // row 3 of each joint's gradient
    dAb[(t / 4) * 16 + 12 + t % 4] = 0.f;
}

int tiles(int V, int per_block) { return (V + per_block - 1) / per_block; }

// B * V slots and their 3 floats must index as int; B is a grid dimension
bool valid(int B, int V) {
  return B > 0 && V > 0 && B <= 65535 && (long long)B * V * 3 < (1LL << 31);
}

}  // namespace

extern "C" {

// v_posed (B, V, 3), weights (V, 16), A (B, 16, 4, 4) -> out (B, V, 3), all
// contiguous f32, 16-byte aligned; B <= 65535. Returns the launch's
// cudaGetLastError() (0 = success); never synchronises.
int lbs_apply(int device, const void* v_posed, const void* weights,
              const void* A, void* out, int B, int V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(B, V)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(V, LBS_THREADS * LBS_VERTS_A_THREAD), B);
  lbs_kernel<<<grid, LBS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)v_posed, (const float*)weights, (const float*)A,
      (float*)out, V);
  return (int)cudaGetLastError();
}

// The floor: an empty kernel on lbs_apply's grid for (B, V).
int lbs_empty(int device, int B, int V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(B, V)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(V, LBS_THREADS * LBS_VERTS_A_THREAD), B);
  lbs_empty_kernel<<<grid, LBS_THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The floor with the forward's bytes: out = v_posed, (B, V, 3) f32, on
// lbs_apply's grid and vertices a thread.
int lbs_copy(int device, const void* v_posed, void* out, int B, int V,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(B, V)) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(V, LBS_THREADS * LBS_VERTS_A_THREAD), B);
  lbs_copy_kernel<<<grid, LBS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)v_posed, (float*)out, V);
  return (int)cudaGetLastError();
}

// The gradient of lbs_apply: v_posed (B, V, 3), weights (V, 16), A (B, 16, 4,
// 4), g = d out (B, V, 3) -> dv (B, V, 3), dA (B, 16, 4, 4), all contiguous
// f32, 16-byte aligned; V <= 1024. Returns the launch's cudaGetLastError().
int lbs_apply_bwd(int device, const void* v_posed, const void* weights,
                  const void* A, const void* g, void* dv, void* dA, int B,
                  int V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(B, V) || V > BWD_MAX_V) return (int)cudaErrorInvalidValue;
  // the kernel may take shared memory for BWD_MAX_V vertices: set once a
  // device, as the host call costs more than the kernel runs
  static bool opted_in[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(
        lbs_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem_floats(BWD_MAX_V) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  const int smem = bwd_smem_floats(V) * (int)sizeof(float);
  lbs_bwd_kernel<<<2 * B, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)v_posed, (const float*)weights, (const float*)A,
      (const float*)g, (float*)dv, (float*)dA, V);
  return (int)cudaGetLastError();
}

const char* lbs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
