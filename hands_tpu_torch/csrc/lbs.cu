// Fused linear blend skinning for NVIDIA Hopper (sm_90a): per vertex, blend
// the 16 joint transforms with the vertex's skinning weights and apply the
// blend to [v, 1]; the per-vertex transform tensor T (B, V, 4, 4) never
// reaches device memory. Plain C interface, built with nvcc and loaded with
// ctypes by hands_tpu_torch/ops/mano_lbs.py.
//
// Replaces: hands_tpu/ops/mano_pallas.py:64 lbs_apply (pl.pallas_call at :90,
// body _lbs_kernel at :41). The TPU kernel pads the vertices to 896 and the
// batch to 8 and contracts through a (16, 4) group-sum matrix, because Mosaic
// cannot reshape the lane dimension; none of that is the function, and none
// of it is here.
//
// What bounds it on this card: per (sample, vertex) it reads 12 B, writes
// 12 B and does 16 * 12 FMAs for the blend plus 9 for the apply, 402 FLOP on
// 24 B: 17 FLOP per byte against the card's 20 (67 TFLOP/s f32 over
// 3.35 TB/s), so bytes and operations bound it about equally, at
// microseconds for a batch of 512. What this design does about it: one
// thread per (sample, vertex); the sample's 16 transforms (top three rows,
// 192 floats) staged once per block in shared memory and read as broadcasts;
// the vertex's 16 weights read as four 16-byte loads; f32 FMAs on the CUDA
// cores (the contraction depth is 16 and this is geometry: no TF32).

#include <cuda_runtime.h>

namespace {

constexpr int LBS_THREADS = 128;
constexpr int LBS_JOINTS = 16;

__global__ void __launch_bounds__(LBS_THREADS)
lbs_kernel(const float* __restrict__ v_posed,   // (B, V, 3)
           const float* __restrict__ weights,   // (V, 16)
           const float* __restrict__ A,         // (B, 16, 4, 4)
           float* __restrict__ out,             // (B, V, 3)
           int V) {
  __shared__ float sA[LBS_JOINTS * 12];  // rows 0..2 of each joint's 4x4
  const int b = blockIdx.y;
  const float* Ab = A + (size_t)b * LBS_JOINTS * 16;
  for (int i = threadIdx.x; i < LBS_JOINTS * 12; i += LBS_THREADS)
    sA[i] = Ab[(i / 12) * 16 + (i % 12)];
  __syncthreads();

  const int v = blockIdx.x * LBS_THREADS + threadIdx.x;
  if (v >= V) return;

  float w[LBS_JOINTS];
  const float4* w4 = reinterpret_cast<const float4*>(weights + (size_t)v * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = w4[q];
    w[4 * q] = t.x; w[4 * q + 1] = t.y; w[4 * q + 2] = t.z; w[4 * q + 3] = t.w;
  }
  float T[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) T[e] = 0.f;
#pragma unroll
  for (int j = 0; j < LBS_JOINTS; ++j) {
#pragma unroll
    for (int e = 0; e < 12; ++e) T[e] = fmaf(w[j], sA[j * 12 + e], T[e]);
  }
  const float* vp = v_posed + ((size_t)b * V + v) * 3;
  const float x = vp[0], y = vp[1], z = vp[2];
  float* o = out + ((size_t)b * V + v) * 3;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = fmaf(T[4 * r], x, fmaf(T[4 * r + 1], y,
                                  fmaf(T[4 * r + 2], z, T[4 * r + 3])));
}

}  // namespace

extern "C" {

// v_posed (B, V, 3), weights (V, 16), A (B, 16, 4, 4) -> out (B, V, 3), all
// contiguous f32; weights 16-byte aligned. Returns the launch's
// cudaGetLastError() (0 = success); never synchronises.
int lbs_apply(int device, const void* v_posed, const void* weights,
              const void* A, void* out, int B, int V, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || V <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + LBS_THREADS - 1) / LBS_THREADS, B);
  lbs_kernel<<<grid, LBS_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)v_posed, (const float*)weights, (const float*)A,
      (float*)out, V);
  return (int)cudaGetLastError();
}

const char* lbs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
