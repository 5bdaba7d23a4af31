// Gaussian vertex-splat silhouette and its gradient for NVIDIA Hopper
// (sm_90a): the (B, P, V) pixel-vertex pair tensor never reaches device
// memory, and the pairs whose gaussian is exactly 0 in f32 are not
// evaluated. Plain C interface, built with nvcc and loaded with ctypes by
// hands_tpu_torch/ops/rasterizer.py.
//
// Replaces: hands_tpu/ops/rasterizer_pallas.py:96 splat_silhouette_fused
// (custom_vjp; forward pl.pallas_call at :128, body _fwd_kernel at :39;
// backward pl.pallas_call at :174, body _bwd_kernel at :58).
//
//   forward   lm[b, p]   = sum_v log1p(-min(g, 1 - 1e-6)),
//             g          = exp(-max(d2, 0) / (2 sigma^2)),
//             mask[b, p] = 1 - exp(lm[b, p])
//   backward  dv[b, v]   = 2 sum_p C (v - pix_p),
//             C          = A_p g / (1 - g) / (2 sigma^2),
//             A_p        = -gmask[b, p] exp(lm[b, p])
//
// d2 is formed as the TPU kernel and the plain version form it,
// (|p|^2 + |v|^2) - 2 p.v with p.v = fma(p_y, v_y, p_x * v_x), every step
// rounded to f32 on its own (the intrinsics below are never contracted): at
// coordinates up to 112 the terms reach 25,000 and cancel to a few pixels
// squared, so any other rounding order moves d2 by ~1e-3 and the mask by
// more than the 2e-5 it is held to. expf and log1pf are the accurate
// library functions (no fast-math). The backward sums C (v - pix) directly,
// which spares it the second cancellation of the TPU kernel's
// 2 (v sum C - sum C pix).
//
// The cut. expf(x) is exactly 0 for every f32 x <= kExpZero (-103.972084,
// the largest f32 below -150 ln 2: the true value is under half the least
// subnormal). The host passes cut, the least f32 d2 with
// __fdiv_rn(-d2, 2 sigma^2) <= kExpZero (ops/rasterizer.py:cut_d2): 468 px^2,
// a radius of 21.6 px, at sigma 1.5. A pair with g = 0 adds log1pf(-0) = -0
// to the forward's sum, which leaves every f32 value as it was, and
// A 0 / (1 - 0) (v - pix) = 0 to the backward's: skipping it changes no
// output. The forward skips a pair when its computed d2 >= cut, the backward
// when its exponent -d2 / (2 sigma^2) <= kExpZero: exactly the pairs whose
// expf is 0.
//
// The margin. Both kernels also skip whole regions (a tile's vertices, the
// pixels outside a vertex's rectangle) without computing d2, so they decide
// on the exact distance, formed in f64 from the f32 coordinates. The
// computed d2 cancels: it can lie below the exact one by about 5 roundings
// of |p|^2 + |v|^2. So a region is skipped only where the exact distance
// reaches skip_threshold = cut + 2^-20 (cut + 2 res^2 + |v|^2), which covers
// three times that rounding (with |p|^2 <= 2 res^2) and the backward's
// product by 1 / (2 sigma^2) in place of the division; the f64 rounding of
// the test itself is negligible against it. ops/rasterizer.py:skip_threshold
// is the same formula.
//
// Non-finite and far vertices. A vertex with a coordinate beyond kFar =
// 1e18 px, infinite or NaN is never skipped (its f32 products can
// overflow): the forward evaluates it against every pixel of every tile, as
// the dense loop did (a NaN distance becomes 0 in fmaxf, so such a vertex
// covers every pixel with the clipped g), and the backward takes the whole
// canvas as its rectangle and evaluates every pair. Every rectangle bound
// is clamped to [0, res] in f64 before it is converted to int, so no
// coordinate indexes outside the canvas.
//
// What bounds it on this card: operations, two special-function results a
// pair that the function needs (g > 0): at B = 64, res = 112, V = 778 and
// sigma 1.5, 11.7% of the 6.2e8 pairs for a hand-sized blob of vertices,
// against 3.6 MB (forward) or 7.2 MB (backward) of traffic. What this
// design does about it:
// - forward: one block per (sample, 16 x 16 pixel tile), a thread a pixel,
//   a warp an 8 x 4 patch. The block walks the sample's vertices, tests
//   each against the tile's rectangle of pixel centres widened by the cut,
//   and compacts those that can reach it into shared memory as (x, y,
//   |v|^2) in vertex order (__ballot_sync / __popc within a warp, one prefix
//   over the warps). The per-pair loop is the dense kernel's, in vertex
//   order, with the pairs at d2 >= cut left out (a warp whose pixels are all
//   past the cut of a vertex skips its exp and log1p): lm and mask are bit
//   for bit the dense loop's. A tile whose kept vertices all reach all its
//   pixels runs the loop without the test. Blocks take the tiles centre
//   first, every sample's ring before the next ring (ring_tile): the tiles
//   under the hand are the long ones, and started last they trail the
//   launch (9% of the forward at the main path's shape).
// - backward: a block takes 32 vertices of one sample and first stages the
//   sample's A map (res^2 floats, one exp a pixel) in shared memory; past
//   128^2 pixels it reads A from device memory and computes it a pair. A
//   warp takes one vertex at a time and walks the pixels of its rectangle
//   (the cut radius plus the margin around it, clipped to the canvas: 44 x 44
//   at sigma 1.5), 32 consecutive pixels at a time; pixels outside the disc
//   cost the distance only. A shuffle reduction sums the warp's (gx, gy).
//   The summation order differs from the dense kernel's, and g / (1 - g) is
//   __fdividef's (within 2 ulp), so dv is held to the f32 twin and the f64
//   twin, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;  // forward: pixels a tile edge
constexpr int FWD_THREADS = TILE * TILE;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int PATCH_W = 8, PATCH_H = 4;  // a warp's pixels within the tile
static_assert(PATCH_W * PATCH_H == 32 && TILE % PATCH_W == 0 &&
                  TILE % PATCH_H == 0, "a warp is one patch of the tile");
constexpr int BWD_WARPS = 8;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_VERTS = 32;             // vertices a backward block
constexpr int BWD_STAGED = 128 * 128;     // A maps staged up to this size
constexpr float kExpZero = -0x1.9fe36ap+6f;  // the largest f32 with expf 0
constexpr float kFar = 1e18f;  // never skip a vertex beyond (or non-finite)
constexpr double kMargin = 0x1p-20;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clip_g() { return (float)(1.0 - 1e-6); }

// max((|p|^2 + |v|^2) - 2 p.v, 0), each step rounded on its own
__device__ __forceinline__ float dist2(float px, float py, float psq,
                                       float vx, float vy, float vsq) {
  const float cross = __fmaf_rn(py, vy, __fmul_rn(px, vx));
  return fmaxf(__fsub_rn(__fadd_rn(psq, vsq), __fmul_rn(2.0f, cross)), 0.0f);
}

__device__ __forceinline__ float sq_norm(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// false for NaN and infinite coordinates too
__device__ __forceinline__ bool skippable(float x, float y) {
  return fabsf(x) <= kFar && fabsf(y) <= kFar;
}

// the exact squared distance from which a pair of vertex (x, y) is skipped
__device__ __forceinline__ double skip_threshold(float x, float y, float cut,
                                                 int res) {
  const double vsq = (double)x * x + (double)y * y;
  return (double)cut + kMargin * ((double)cut + 2.0 * res * res + vsq);
}

// tile of rank r (< n^2) in an n x n grid, centre first: ring by ring
// outward (the square of side s holds the s^2 tiles of ranks below s^2,
// s of the parity of n), each ring clockwise from its top-left corner. The
// hand sits near the centre of a crop, so its tiles, the long ones, start
// first and do not trail the launch
__device__ __forceinline__ int2 ring_tile(int r, int n) {
  int s = (int)sqrtf((float)r);
  while (s * s > r) --s;
  while ((s + 1) * (s + 1) <= r) ++s;
  s += 1;  // the least side with s^2 > r
  if ((s - n) & 1) ++s;
  const int j = (n - s) / 2;  // the ring's top-left corner (j, j)
  if (s == 1) return make_int2(j, j);
  const int e = s - 1, o = r - (s - 2) * (s - 2);
  if (o < e) return make_int2(j + o, j);
  if (o < 2 * e) return make_int2(j + e, j + o - e);
  if (o < 3 * e) return make_int2(j + e - (o - 2 * e), j + e);
  return make_int2(j, j + e - (o - 3 * e));
}

// the log-miss sum of pixel (px, py) over the n kept vertices, in vertex
// order; kSkip: leave out the pairs at d2 >= cut, which would add -0
template <bool kSkip>
__device__ __forceinline__ float log_miss(float px, float py,
                                          const float* sx, const float* sy,
                                          const float* sq, int n,
                                          float two_s2, float cut) {
  const float psq = sq_norm(px, py);
  const float clip = clip_g();
  float lm = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float d2 = dist2(px, py, psq, sx[k], sy[k], sq[k]);
    if (!kSkip || d2 < cut) {
      const float g = fminf(expf(__fdiv_rn(-d2, two_s2)), clip);
      lm += log1pf(-g);
    }
  }
  return lm;
}

__global__ void __launch_bounds__(FWD_THREADS)
splat_fwd_kernel(const float* __restrict__ v2d,  // (B, V, 2)
                 float* __restrict__ lm_out,     // (B, P)
                 float* __restrict__ mask_out,   // (B, P)
                 int V, int res, float two_s2, float cut) {
  extern __shared__ float sm[];  // x, y, |v|^2 of the kept vertices
  float* sx = sm;
  float* sy = sm + V;
  float* sq = sm + 2 * V;
  __shared__ int warp_kept[FWD_WARPS];
  const int b = blockIdx.x;
  const int P = res * res;
  const int tiles_x = (res + TILE - 1) / TILE;
  const int2 tile = ring_tile(blockIdx.y, tiles_x);
  const int x0 = tile.x * TILE, y0 = tile.y * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the tile's pixel centres span [cx0, cx1] x [cy0, cy1]
  const double cx0 = x0 + 0.5, cx1 = min(x0 + TILE, res) - 0.5;
  const double cy0 = y0 + 0.5, cy1 = min(y0 + TILE, res) - 0.5;
  const float* v = v2d + (size_t)b * V * 2;
  int kept = 0;
  bool within = true;  // every kept vertex reaches every pixel of the tile
  for (int base = 0; base < V; base += FWD_THREADS) {
    const int i = base + threadIdx.x;
    float x = 0.0f, y = 0.0f;
    bool keep = false;
    if (i < V) {
      x = v[2 * i];
      y = v[2 * i + 1];
      keep = true;
      if (skippable(x, y)) {
        const double dx = fmax(fmax(cx0 - x, x - cx1), 0.0);
        const double dy = fmax(fmax(cy0 - y, y - cy1), 0.0);
        keep = dx * dx + dy * dy < skip_threshold(x, y, cut, res);
      }
      // the farthest pixel centre well within the cut (a choice of loop,
      // not of result: the loop without the test adds the same terms)
      const double fx = fmax(fabs(cx0 - x), fabs(cx1 - x));
      const double fy = fmax(fabs(cy0 - y), fabs(cy1 - y));
      within = within && (!keep || fx * fx + fy * fy < 0.999 * cut);
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int slot = kept + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < FWD_WARPS; ++w) {
      const int n = warp_kept[w];
      slot += w < warp ? n : 0;
      kept += n;
    }
    if (keep) {
      sx[slot] = x;
      sy[slot] = y;
      sq[slot] = sq_norm(x, y);
    }
    __syncthreads();  // warp_kept may be reused
  }
  // the list is complete (the loop ends in a barrier); where no pair of the
  // tile is past the cut, the loop needs no test
  const bool dense = __syncthreads_and(within);
  const int px_i = x0 + (warp % (TILE / PATCH_W)) * PATCH_W + lane % PATCH_W;
  const int py_i = y0 + (warp / (TILE / PATCH_W)) * PATCH_H + lane / PATCH_W;
  if (px_i >= res || py_i >= res) return;
  const float px = (float)px_i + 0.5f, py = (float)py_i + 0.5f;
  const float lm =
      dense ? log_miss<false>(px, py, sx, sy, sq, kept, two_s2, cut)
            : log_miss<true>(px, py, sx, sy, sq, kept, two_s2, cut);
  const size_t o = (size_t)b * P + py_i * res + px_i;
  lm_out[o] = lm;
  mask_out[o] = 1.0f - expf(lm);
}

// kStaged: the sample's A map in shared memory (res^2 <= BWD_STAGED);
// otherwise A is computed from lm and gmask for each pair evaluated
template <bool kStaged>
__global__ void __launch_bounds__(BWD_THREADS)
splat_bwd_kernel(const float* __restrict__ v2d,    // (B, V, 2)
                 const float* __restrict__ lm,     // (B, P)
                 const float* __restrict__ gmask,  // (B, P)
                 float* __restrict__ dv,           // (B, V, 2)
                 int V, int res, float inv2s2, float cut) {
  extern __shared__ float sA[];  // A_p of the sample's pixels (kStaged)
  const int b = blockIdx.y;
  const int P = res * res;
  const float* lm_b = lm + (size_t)b * P;
  const float* gm_b = gmask + (size_t)b * P;
  if (kStaged) {
    for (int p = threadIdx.x; p < P; p += BWD_THREADS)
      sA[p] = -gm_b[p] * expf(lm_b[p]);
    __syncthreads();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float clip = clip_g();
  const int v_end = min(V, (int)(blockIdx.x + 1) * BWD_VERTS);
  for (int vi = blockIdx.x * BWD_VERTS + warp; vi < v_end;
       vi += BWD_WARPS) {
    const float vx = v2d[((size_t)b * V + vi) * 2];
    const float vy = v2d[((size_t)b * V + vi) * 2 + 1];
    const float vsq = sq_norm(vx, vy);
    // pixel columns [i0, i1) and rows [j0, j1): those within the skip
    // threshold's radius of the vertex, clamped to the canvas in f64
    int i0 = 0, i1 = res, j0 = 0, j1 = res;
    const bool skip = skippable(vx, vy);
    if (skip) {
      const double r = sqrt(skip_threshold(vx, vy, cut, res));
      const double hi = (double)res;
      i0 = (int)fmin(fmax(floor(vx - 0.5 - r) + 1.0, 0.0), hi);
      i1 = (int)fmin(fmax(ceil(vx - 0.5 + r), 0.0), hi);
      j0 = (int)fmin(fmax(floor(vy - 0.5 - r) + 1.0, 0.0), hi);
      j1 = (int)fmin(fmax(ceil(vy - 0.5 + r), 0.0), hi);
    }
    const int w = i1 - i0, h = j1 - j0;
    float gx = 0.0f, gy = 0.0f;
    if (w > 0 && h > 0) {
      // the lane's pixel (column c, row r of the rectangle), 32 on a step
      const int dr = 32 / w, dc = 32 % w;
      int c = lane % w;
      int p = (j0 + lane / w) * res + i0 + c;
      float qx = (float)(i0 + c) + 0.5f, qy = (float)(j0 + lane / w) + 0.5f;
      const float dcf = (float)dc, drf = (float)dr, wf = (float)w;
      for (int k = lane; k < w * h; k += 32) {
        const float d2 = dist2(qx, qy, sq_norm(qx, qy), vx, vy, vsq);
        const float e = -d2 * inv2s2;
        if (e > kExpZero || !skip) {  // else expf(e) is 0: the term is 0
          const float a = kStaged ? sA[p] : -gm_b[p] * expf(lm_b[p]);
          const float g = fminf(expf(e), clip);
          // not the IEEE division: it takes a slow path for the zero and
          // subnormal numerators that a * g often is, divergent across the
          // warp's pixels (3x the time); __fdividef is within 2 ulp for a
          // divisor in [1e-6, 1]
          const float cg = __fdividef(a * g, 1.0f - g) * inv2s2;
          gx += cg * (vx - qx);
          gy += cg * (vy - qy);
        }
        c += dc;
        p += dr * res + dc;
        qx += dcf;
        qy += drf;
        if (c >= w) {
          c -= w;
          p += res - w;
          qx -= wf;
          qy += 1.0f;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gx += __shfl_xor_sync(kFull, gx, o);
      gy += __shfl_xor_sync(kFull, gy, o);
    }
    if (lane == 0) {
      dv[((size_t)b * V + vi) * 2] = 2.0f * gx;
      dv[((size_t)b * V + vi) * 2 + 1] = 2.0f * gy;
    }
  }
}

}  // namespace

extern "C" {

// v2d (B, V, 2) -> lm, mask (B, res*res); contiguous f32. cut: the least
// squared distance whose gaussian is 0 (ops/rasterizer.py:cut_d2). Returns
// the launch's cudaGetLastError() (0 = success); never synchronises.
int splat_fwd(int device, const void* v2d, void* lm, void* mask, int B, int V,
              int res, float sigma, float cut, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || V <= 0 || res <= 0 || B > 65535 || !(sigma > 0.0f) ||
      !(cut > 0.0f))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)V * 3 * sizeof(float);
  err = cudaFuncSetAttribute(splat_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (res + TILE - 1) / TILE;
  if (tiles_x * tiles_x > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, tiles_x * tiles_x);  // every sample's centre tiles first
  splat_fwd_kernel<<<grid, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)v2d, (float*)lm, (float*)mask, V, res,
      2.0f * sigma * sigma, cut);
  return (int)cudaGetLastError();
}

// v2d (B, V, 2), lm and gmask (B, res*res) -> dv (B, V, 2); contiguous f32.
int splat_bwd(int device, const void* v2d, const void* lm, const void* gmask,
              void* dv, int B, int V, int res, float sigma, float cut,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || V <= 0 || res <= 0 || B > 65535 || !(sigma > 0.0f) ||
      !(cut > 0.0f))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + BWD_VERTS - 1) / BWD_VERTS, B);
  const float inv2s2 = 1.0f / (2.0f * sigma * sigma);
  cudaStream_t s = (cudaStream_t)stream;
  if (res * res <= BWD_STAGED) {
    const size_t smem = (size_t)res * res * sizeof(float);
    err = cudaFuncSetAttribute(splat_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    splat_bwd_kernel<true><<<grid, BWD_THREADS, smem, s>>>(
        (const float*)v2d, (const float*)lm, (const float*)gmask, (float*)dv,
        V, res, inv2s2, cut);
  } else {
    splat_bwd_kernel<false><<<grid, BWD_THREADS, 0, s>>>(
        (const float*)v2d, (const float*)lm, (const float*)gmask, (float*)dv,
        V, res, inv2s2, cut);
  }
  return (int)cudaGetLastError();
}

const char* splat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
