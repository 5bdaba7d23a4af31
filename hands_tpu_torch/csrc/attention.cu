// Fused multi-head attention for NVIDIA Hopper (sm_90a): softmax(q k^T) v per
// (crop, head) with nothing but q, k, v in and o out touching device memory.
// Plain C interface, built with nvcc and loaded with ctypes by
// hands_tpu_torch/ops/attention.py.
//
// Replaces: hands_tpu/ops/attention_pallas.py:52 mha_fused (pl.pallas_call at
// :58, body _mha_kernel at :27), and the attention legs of the two int8 block
// kernels, hands_tpu/ops/vit_block_pallas.py:239-250 (_vit_block_int8_kernel)
// and :342-355 (_vit_block_int8_static_kernel). Three modes, one kernel:
//   MODE_MHA      f32 logits of the raw q, k, times `scale` in f32 after the
//                 dot; probabilities cast to the input type; f32 accumulate;
//                 output in the input type (bf16 or f32)
//   MODE_DYNAMIC  bf16 only: q * scale rounded to bf16 first (`scale` is the
//                 bf16 value of D^-0.5), f32 logits, f32 probabilities, bf16 out
//   MODE_STATIC   as MODE_DYNAMIC but probabilities rounded to bf16 and the
//                 output times inv_out[h*D + d], rounded half to even, clipped
//                 to [-127, 127] and stored as int8
// q, k and v are read in place through a batch stride and a row stride (in
// elements), so the three slices of a fused (B, N, 3, H, D) qkv tensor need no
// copies; head h starts h*D elements into a row. The TPU wrapper's (B,H,N,D)
// transposes are a tiling need of that chip and are not reproduced.
//
// What bounds it on this card: at N = 192, D = 80 a head reads 3 x 30 KB
// (bf16) and writes 30 KB, and does 4*N*N*D = 11.8 MFLOP: 96 FLOP per byte,
// below the bf16 tensor cores' ridge (~295), so bytes bound it (0.009 ms per
// ViT-H block at 3072 rows against 0.003 ms of tensor-core operations).
// What the design does about it: q, k and v are read once from device
// memory, both products run on the tensor cores (mma.sync m16n8k16 with
// ldmatrix operands) and the logits never leave the registers; see
// attention_kernel.cuh. The f32 MODE_MHA runs that geometry as 3xTF32 on the
// TF32 tensor cores (attention_f32.cuh); MODE_MHA_CORES is PR 2's CUDA-core
// loop, which the wrapper picks for the f32 shapes past that route's limits
// (more than 256 tokens, a head dim past 128).

#include "attention_f32.cuh"
#include "attention_kernel.cuh"

constexpr int MODE_MHA_CORES = 7;  // f32 only

// --------------------------------------------------------- C interface
extern "C" {

// is_f32: element type of q, k, v (and of out in MODE_MHA and, f32 only,
// MODE_MHA_CORES).
// Returns the launch's cudaGetLastError() (0 = success),
// cudaErrorInvalidValue for a combination the kernel does not have; never
// synchronises.
int attn_fused(int device, const void* q, const void* k, const void* v,
               void* out, const void* inv_out, int B, int N, int H, int D,
               long long batch_stride, long long row_stride, float scale,
               int is_f32, int mode, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* inv = (const float*)inv_out;
  if (is_f32) {
    const float *qf = (const float*)q, *kf = (const float*)k,
                *vf = (const float*)v;
    if (mode == MODE_MHA)
      return launch_tf32(qf, kf, vf, (float*)out, B, N, H, D, batch_stride,
                         row_stride, scale, s);
    if (mode == MODE_MHA_CORES)
      return launch_f32_cores(qf, kf, vf, (float*)out, B, N, H, D,
                              batch_stride, row_stride, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (mode == MODE_MHA)
    return launch<MODE_MHA>(q, k, v, out, inv, B, N, H, D, batch_stride,
                            row_stride, scale, s);
  if (mode == MODE_DYNAMIC)
    return launch<MODE_DYNAMIC>(q, k, v, out, inv, B, N, H, D, batch_stride,
                                row_stride, scale, s);
  if (mode == MODE_STATIC && inv != nullptr)
    return launch<MODE_STATIC>(q, k, v, out, inv, B, N, H, D, batch_stride,
                               row_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
