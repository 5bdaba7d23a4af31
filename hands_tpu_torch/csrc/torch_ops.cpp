// The serving kernels' ops registered from C++: a launch path with no Python.
//
// Each op of hands_tpu_torch/ops/library.py:OPS (K3's three kernels, K5's and
// K6's four, the int8 blocks' attention, K1's skinning) is registered here in
// the namespace hands_tpu_torch_aoti, with the schema of its Python op
// (hands_tpu_torch::<name>, cuda_build.KernelOp) and two kernels:
//   CUDA  the checks of its Python launch function as TORCH_CHECKs, the
//         outputs from at::empty, the kernel's extern "C" entry on PyTorch's
//         current stream, and a raise on a non-zero return code;
//   Meta  the output shapes and types (what the Python op's fake returns).
// An AOTInductor package of the serving program calls these ops by name
// (through its proxy executor), so a process that loads this library with
// torch.ops.load_library runs the package with torch alone. The ops have a
// namespace of their own because the Python ops stay registered for
// torch.export, and one process cannot register a name twice.
//
// Built with g++ (no CUDA header, no Python, no pybind: torch/library.h and
// ATen only) by hands_tpu_torch/ops/cuda_build.py:TorchOpsLibrary, and linked
// against the per-source libraries that define the entries (vit_block.cu,
// vit_block_int8.cu, attention.cu, lbs.cu), found beside it ($ORIGIN).
// The kernels are unchanged: what the port's TPU kernels became, and what
// bounds them, is in those sources.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <cmath>
#include <cstdint>
#include <optional>
#include <tuple>

extern "C" {
// csrc/vit_block.cu
int vit_layernorm(int device, const void* x, const void* scale,
                  const void* bias, void* out, int rows, int C, float eps,
                  void* stream);
int vit_gemm(int device, const void* a, const void* w, const void* bias,
             const void* residual, void* out, int M, int N, int K,
             int epilogue, void* stream);
int vit_attention(int device, const void* qkv, void* out, int B, int N,
                  int H, int D, float q_scale, void* stream);
const char* vit_error_string(int err);
// csrc/vit_block_int8.cu
int i8_ln_quant(int device, const void* x, int x_is_f32, const void* scale,
                const void* bias, void* q, void* s_out, int rows, int C,
                float eps, void* stream);
int i8_quant_rows(int device, const void* a, int a_is_f32, void* q,
                  void* s_out, int rows, int K, void* stream);
int i8_gemm(int device, const void* a, const void* w, const void* row_scale,
            const void* col_scale, const void* bias, const void* residual,
            const void* inv_next, void* out, int M, int N, int K, int mode,
            int fast_gelu, void* stream);
const char* i8_error_string(int err);
// csrc/attention.cu
int attn_fused(int device, const void* q, const void* k, const void* v,
               void* out, const void* inv_out, int B, int N, int H, int D,
               long long batch_stride, long long row_stride, float scale,
               int is_f32, int mode, void* stream);
const char* attn_error_string(int err);
// csrc/lbs.cu
int lbs_apply(int device, const void* v_posed, const void* weights,
              const void* A, void* out, int B, int V, void* stream);
const char* lbs_error_string(int err);
}

namespace {

using at::Tensor;
using OptTensor = std::optional<Tensor>;
using Pair = std::tuple<Tensor, Tensor>;

constexpr auto kBF16 = at::kBFloat16;
constexpr auto kF32 = at::kFloat;
constexpr auto kI8 = at::kChar;

// csrc/common.cuh WARP_ROW_MAX_C, csrc/attention_kernel.cuh (as
// ops/vit_block.py: LN_MAX_C, ATTN_MAX_N, ATTN_MAX_D)
constexpr int64_t LN_MAX_C = 2048;
constexpr int64_t ATTN_MAX_N = 256;
constexpr int64_t ATTN_MAX_D = 128;
// ops/attention.py: _MODE_DYNAMIC, _MODE_STATIC
constexpr int MODE_DYNAMIC = 1;
constexpr int MODE_STATIC = 2;

// ops/vit_block_int8.py:_GEMM_MODES -> the output type of each i8_gemm mode
at::ScalarType i8_gemm_dtype(int64_t mode) {
  switch (mode) {
    case 0: case 2: case 4: case 5:
      return kBF16;
    case 1: case 3:
      return kF32;
    case 6:
      return kI8;
    default:
      TORCH_CHECK(false, "i8_gemm: no epilogue mode ", mode);
  }
}

const void* ptr(const Tensor& t) { return t.data_ptr(); }
const void* ptr(const OptTensor& t) {
  return t.has_value() ? t->data_ptr() : nullptr;
}

// cuda_build.check: a contiguous, 16-byte aligned tensor of dtype and shape
// on device
void check(const Tensor& t, const char* name, at::ScalarType dtype,
           at::IntArrayRef shape, const at::Device& device) {
  TORCH_CHECK(t.device() == device && t.scalar_type() == dtype &&
                  t.sizes() == shape && t.is_contiguous() &&
                  reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0,
              name, ": want a contiguous 16-byte-aligned ", dtype, " ",
              shape, " on ", device, ", got ", t.scalar_type(), " ",
              t.sizes(), " on ", t.device(),
              " (contiguous=", t.is_contiguous(), ")");
}

// vit_block.check_layernorm_width
void check_layernorm_width(int64_t C) {
  TORCH_CHECK(C % 8 == 0 && 8 <= C && C <= LN_MAX_C,
              "LayerNorm kernel needs a width that is a multiple of 8 up to ",
              LN_MAX_C, " (vectors of 4 values, the row in one warp's "
              "registers), got ", C);
}

// vit_block.check_attention_shape
void check_attention_shape(int64_t N, int64_t D) {
  TORCH_CHECK(D % 16 == 0 && 16 <= D && D <= ATTN_MAX_D,
              "attention kernel needs a head dim that is a multiple of 16 up "
              "to ", ATTN_MAX_D, ", got ", D);
  TORCH_CHECK(1 <= N && N <= ATTN_MAX_N, "attention kernel takes 1 to ",
              ATTN_MAX_N, " tokens (a row of logits in registers), got ", N);
}

// cuda_build.check_gemm_operands
void check_gemm_operands(const Tensor& a, const Tensor& w) {
  const int64_t K = a.size(-1), size = a.element_size();
  TORCH_CHECK(K * size % 16 == 0,
              "GEMM kernel needs rows of a multiple of 16 bytes (TMA): K % ",
              16 / size, " == 0 for ", a.scalar_type(), ", got K=", K);
  TORCH_CHECK(reinterpret_cast<uintptr_t>(a.data_ptr()) % 16 == 0,
              "GEMM kernel needs 16-byte aligned base addresses (TMA): a");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(w.data_ptr()) % 16 == 0,
              "GEMM kernel needs 16-byte aligned base addresses (TMA): w");
}

void check_rows(const Tensor& x, const char* op) {
  TORCH_CHECK(x.dim() == 2, op, ": want (rows, columns), got ",
              x.sizes());
}

// vit_block.bf16_const: v rounded to bf16 (from double through float, as
// torch.tensor(v, dtype=torch.bfloat16) rounds it)
float bf16_const(double v) {
  return static_cast<float>(c10::BFloat16(static_cast<float>(v)));
}

// PyTorch's current stream on the tensor's device, as the Python route
// passes torch.cuda.current_stream(device).cuda_stream
void* stream_of(const at::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())
      ->getStream(device)
      .native_handle();
}

// cuda_build.CudaLibrary.launch: raise if the entry refused the launch
void raise_on(int err, const char* entry, const char* (*error_string)(int)) {
  TORCH_CHECK(err == 0, entry, " launch failed: ", error_string(err), " (",
              err, ")");
}

// ---------------------------------------------------------------- CUDA
// ops/vit_block.py:launch_layernorm
Tensor vit_layernorm_cuda(const Tensor& x, const Tensor& scale,
                          const Tensor& bias, double eps) {
  check_rows(x, "vit_layernorm");
  const int64_t R = x.size(0), C = x.size(1);
  const auto dev = x.device();
  check_layernorm_width(C);
  check(x, "x", kBF16, {R, C}, dev);
  check(scale, "scale", kF32, {C}, dev);
  check(bias, "bias", kF32, {C}, dev);
  Tensor out = at::empty({R, C}, x.options());
  raise_on(vit_layernorm(dev.index(), ptr(x), ptr(scale), ptr(bias),
                         out.data_ptr(), R, C, static_cast<float>(eps),
                         stream_of(dev)),
           "vit_layernorm", vit_error_string);
  return out;
}

// ops/vit_block.py:launch_gemm
Tensor vit_gemm_cuda(const Tensor& a, const Tensor& w, const Tensor& bias,
                     const OptTensor& residual, c10::SymInt epilogue) {
  check_rows(a, "vit_gemm");
  check_rows(w, "vit_gemm");
  const int64_t M = a.size(0), K = a.size(1), N = w.size(0);
  const auto dev = a.device();
  check_gemm_operands(a, w);
  check(a, "a", kBF16, {M, K}, dev);
  check(w, "w", kBF16, {N, K}, dev);
  check(bias, "bias", kBF16, {N}, dev);
  if (residual.has_value()) check(*residual, "residual", kBF16, {M, N}, dev);
  Tensor out = at::empty({M, N}, a.options().dtype(kBF16));
  raise_on(vit_gemm(dev.index(), ptr(a), ptr(w), ptr(bias), ptr(residual),
                    out.data_ptr(), M, N, K,
                    static_cast<int>(epilogue.expect_int()), stream_of(dev)),
           "vit_gemm", vit_error_string);
  return out;
}

// ops/vit_block.py:_attention_shape and launch_attention
Tensor vit_attention_cuda(const Tensor& qkv, c10::SymInt num_heads_) {
  TORCH_CHECK(qkv.dim() == 3, "vit_attention: want (B, N, 3C), got ",
              qkv.sizes());
  const int64_t H = num_heads_.expect_int();
  const int64_t B = qkv.size(0), N = qkv.size(1), C3 = qkv.size(2),
                C = C3 / 3;
  TORCH_CHECK(C3 % 3 == 0 && C % H == 0, "attention kernel needs 3C "
              "columns, got ", C3, " columns, ", H, " heads");
  const int64_t D = C / H;
  check_attention_shape(N, D);
  const auto dev = qkv.device();
  check(qkv, "qkv", kBF16, {B, N, 3 * C}, dev);
  Tensor out = at::empty({B, N, C}, qkv.options().dtype(kBF16));
  raise_on(vit_attention(dev.index(), ptr(qkv), out.data_ptr(), B, N, H, D,
                         bf16_const(std::pow(static_cast<double>(D), -0.5)),
                         stream_of(dev)),
           "vit_attention", vit_error_string);
  return out;
}

// ops/vit_block_int8.py:_launch_ln_quant
Pair ln_quant(const Tensor& x, const Tensor& scale, const Tensor& bias,
              bool dynamic, double eps) {
  check_rows(x, "ln_quant");
  const int64_t R = x.size(0), C = x.size(1);
  const auto dev = x.device();
  const auto dtype = x.scalar_type();
  TORCH_CHECK(dtype == kBF16 || dtype == kF32,
              "ln_quant takes bf16 or f32 rows, got ", dtype);
  check_layernorm_width(C);
  check(x, "x", dtype, {R, C}, dev);
  check(scale, "scale", kF32, {C}, dev);
  check(bias, "bias", kF32, {C}, dev);
  Tensor q = at::empty({R, C}, x.options().dtype(kI8));
  Tensor s;
  if (dynamic) s = at::empty({R, 1}, x.options().dtype(kF32));
  raise_on(i8_ln_quant(dev.index(), ptr(x), dtype == kF32, ptr(scale),
                       ptr(bias), q.data_ptr(),
                       dynamic ? s.data_ptr() : nullptr, R, C,
                       static_cast<float>(eps), stream_of(dev)),
           "i8_ln_quant", i8_error_string);
  return {q, s};
}

Pair i8_ln_quant_dynamic_cuda(const Tensor& x, const Tensor& scale,
                              const Tensor& bias, double eps) {
  return ln_quant(x, scale, bias, true, eps);
}

Tensor i8_ln_quant_static_cuda(const Tensor& x, const Tensor& scale,
                               const Tensor& bias, double eps) {
  return std::get<0>(ln_quant(x, scale, bias, false, eps));
}

// ops/vit_block_int8.py:launch_quant_rows
Pair i8_quant_rows_cuda(const Tensor& a) {
  check_rows(a, "quant_rows");
  const int64_t R = a.size(0), K = a.size(1);
  const auto dev = a.device();
  const auto dtype = a.scalar_type();
  TORCH_CHECK(dtype == kBF16 || dtype == kF32,
              "quant_rows takes bf16 or f32 rows, got ", dtype);
  check(a, "a", dtype, {R, K}, dev);
  Tensor q = at::empty({R, K}, a.options().dtype(kI8));
  Tensor s = at::empty({R, 1}, a.options().dtype(kF32));
  raise_on(i8_quant_rows(dev.index(), ptr(a), dtype == kF32, q.data_ptr(),
                         s.data_ptr(), R, K, stream_of(dev)),
           "i8_quant_rows", i8_error_string);
  return {q, s};
}

// ops/vit_block_int8.py:launch_gemm_i8
Tensor i8_gemm_cuda(const Tensor& a_q, const Tensor& w_q,
                    const Tensor& col_scale, const Tensor& bias,
                    const OptTensor& row_scale, const OptTensor& residual,
                    const OptTensor& inv_next, c10::SymInt mode_,
                    bool fast_gelu) {
  check_rows(a_q, "i8_gemm");
  check_rows(w_q, "i8_gemm");
  const int64_t M = a_q.size(0), K = a_q.size(1), N = w_q.size(0);
  const int64_t mode = mode_.expect_int();
  const auto dev = a_q.device();
  const bool dynamic = row_scale.has_value();
  check_gemm_operands(a_q, w_q);
  check(a_q, "a_q", kI8, {M, K}, dev);
  check(w_q, "w_q", kI8, {N, K}, dev);
  check(col_scale, "col_scale", kF32, {N}, dev);
  check(bias, "bias", kF32, {N}, dev);
  if (dynamic) check(*row_scale, "row_scale", kF32, {M, 1}, dev);
  if (residual.has_value())
    check(*residual, "residual", dynamic ? kF32 : kBF16, {M, N}, dev);
  if (inv_next.has_value()) check(*inv_next, "inv_next", kF32, {N}, dev);
  Tensor out = at::empty({M, N}, a_q.options().dtype(i8_gemm_dtype(mode)));
  raise_on(i8_gemm(dev.index(), ptr(a_q), ptr(w_q), ptr(row_scale),
                   ptr(col_scale), ptr(bias), ptr(residual), ptr(inv_next),
                   out.data_ptr(), M, N, K, static_cast<int>(mode),
                   fast_gelu, stream_of(dev)),
           "i8_gemm", i8_error_string);
  return out;
}

// ops/attention.py:launch_qkv_attention and _launch: q, k and v are the
// three column blocks of the fused (B, N, 3C) qkv, read in place through a
// batch stride of N * 3C and a row stride of 3C elements
Tensor qkv_attention_cuda(const Tensor& qkv, c10::SymInt num_heads_,
                          const OptTensor& inv_out) {
  TORCH_CHECK(qkv.dim() == 3, "qkv_attention: want (B, N, 3C), got ",
              qkv.sizes());
  const int64_t H = num_heads_.expect_int();
  const int64_t B = qkv.size(0), N = qkv.size(1), C3 = qkv.size(2),
                C = C3 / 3, D = C / H;
  const auto dev = qkv.device();
  TORCH_CHECK(C3 % 3 == 0 && C % H == 0, "attention kernel needs 3C "
              "columns, got ", C3, " columns, ", H, " heads");
  check(qkv, "qkv", kBF16, {B, N, C3}, dev);
  const bool is_static = inv_out.has_value();
  if (is_static) check(*inv_out, "inv_out", kF32, {C}, dev);
  Tensor out = at::empty({B, N, C}, qkv.options().dtype(is_static ? kI8
                                                                  : kBF16));
  const long long row_stride = C3, batch_stride = N * C3;
  const auto base = reinterpret_cast<uintptr_t>(qkv.data_ptr());
  const auto esize = static_cast<uintptr_t>(qkv.element_size());
  const uintptr_t q = base, k = base + C * esize, v = base + 2 * C * esize;
  check_attention_shape(N, D);
  TORCH_CHECK(batch_stride % 8 == 0 && row_stride % 8 == 0 && q % 16 == 0 &&
                  k % 16 == 0 && v % 16 == 0,
              "bf16 attention kernel needs 16-byte aligned q, k, v and "
              "strides that are multiples of 8 elements");
  raise_on(attn_fused(dev.index(), reinterpret_cast<const void*>(q),
                      reinterpret_cast<const void*>(k),
                      reinterpret_cast<const void*>(v), out.data_ptr(),
                      ptr(inv_out), B, N, H, D, batch_stride, row_stride,
                      bf16_const(std::pow(static_cast<double>(D), -0.5)),
                      0, is_static ? MODE_STATIC : MODE_DYNAMIC,
                      stream_of(dev)),
           "attn_fused", attn_error_string);
  return out;
}

// ops/mano_lbs.py:_check_operands and launch_lbs_apply
Tensor lbs_apply_cuda(const Tensor& v_posed, const Tensor& lbs_weights,
                      const Tensor& A) {
  TORCH_CHECK(v_posed.dim() == 3, "v_posed: want (B, V, 3), got ",
              v_posed.sizes());
  const int64_t B = v_posed.size(0), V = v_posed.size(1), J = 16;
  const auto dev = v_posed.device();
  check(v_posed, "v_posed", kF32, {B, V, 3}, dev);
  check(lbs_weights, "lbs_weights", kF32, {V, J}, dev);
  check(A, "A", kF32, {B, J, 4, 4}, dev);
  Tensor out = at::empty({B, V, 3}, v_posed.options());
  raise_on(lbs_apply(dev.index(), ptr(v_posed), ptr(lbs_weights), ptr(A),
                     out.data_ptr(), B, V, stream_of(dev)),
           "lbs_apply", lbs_error_string);
  return out;
}

// ---------------------------------------------------------------- Meta
// The shapes and types of each op's Python fake (cuda_build.KernelOp)
Tensor same_meta(const Tensor& x, const Tensor&, const Tensor&, double) {
  return at::empty_symint(x.sym_sizes(), x.options());
}

Tensor vit_gemm_meta(const Tensor& a, const Tensor& w, const Tensor&,
                     const OptTensor&, c10::SymInt) {
  return at::empty_symint({a.sym_size(0), w.sym_size(0)}, a.options());
}

Tensor columns_third(const Tensor& qkv, at::ScalarType dtype) {
  return at::empty_symint({qkv.sym_size(0), qkv.sym_size(1),
                           qkv.sym_size(2) / 3},
                          qkv.options().dtype(dtype));
}

Tensor vit_attention_meta(const Tensor& qkv, c10::SymInt) {
  return columns_third(qkv, qkv.scalar_type());
}

Pair rows_and_scales_meta(const Tensor& x) {
  return {at::empty_symint(x.sym_sizes(), x.options().dtype(kI8)),
          at::empty_symint({x.sym_size(0), 1}, x.options().dtype(kF32))};
}

Pair i8_ln_quant_dynamic_meta(const Tensor& x, const Tensor&, const Tensor&,
                              double) {
  return rows_and_scales_meta(x);
}

Tensor i8_ln_quant_static_meta(const Tensor& x, const Tensor&, const Tensor&,
                               double) {
  return at::empty_symint(x.sym_sizes(), x.options().dtype(kI8));
}

Tensor i8_gemm_meta(const Tensor& a_q, const Tensor& w_q, const Tensor&,
                    const Tensor&, const OptTensor&, const OptTensor&,
                    const OptTensor&, c10::SymInt mode, bool) {
  return at::empty_symint({a_q.sym_size(0), w_q.sym_size(0)},
                          a_q.options().dtype(
                              i8_gemm_dtype(mode.expect_int())));
}

Tensor qkv_attention_meta(const Tensor& qkv, c10::SymInt,
                          const OptTensor& inv_out) {
  return columns_third(qkv, inv_out.has_value() ? kI8 : kBF16);
}

Tensor lbs_apply_meta(const Tensor& v_posed, const Tensor&, const Tensor&) {
  return at::empty_symint(v_posed.sym_sizes(), v_posed.options());
}

}  // namespace

// The schemas of the Python ops (tests/test_torch_aoti.py holds them equal)
TORCH_LIBRARY(hands_tpu_torch_aoti, m) {
  m.def("vit_layernorm(Tensor x, Tensor scale, Tensor bias, float eps) -> "
        "Tensor");
  m.def("vit_gemm(Tensor a, Tensor w, Tensor bias, Tensor? residual, "
        "SymInt epilogue) -> Tensor");
  m.def("vit_attention(Tensor qkv, SymInt num_heads) -> Tensor");
  m.def("i8_ln_quant_dynamic(Tensor x, Tensor scale, Tensor bias, float eps) "
        "-> (Tensor, Tensor)");
  m.def("i8_ln_quant_static(Tensor x, Tensor scale, Tensor bias, float eps) "
        "-> Tensor");
  m.def("i8_quant_rows(Tensor a) -> (Tensor, Tensor)");
  m.def("i8_gemm(Tensor a_q, Tensor w_q, Tensor col_scale, Tensor bias, "
        "Tensor? row_scale, Tensor? residual, Tensor? inv_next, SymInt mode, "
        "bool fast_gelu) -> Tensor");
  m.def("qkv_attention(Tensor qkv, SymInt num_heads, Tensor? inv_out) -> "
        "Tensor");
  m.def("lbs_apply(Tensor v_posed, Tensor lbs_weights, Tensor A) -> Tensor");
}

TORCH_LIBRARY_IMPL(hands_tpu_torch_aoti, CUDA, m) {
  m.impl("vit_layernorm", &vit_layernorm_cuda);
  m.impl("vit_gemm", &vit_gemm_cuda);
  m.impl("vit_attention", &vit_attention_cuda);
  m.impl("i8_ln_quant_dynamic", &i8_ln_quant_dynamic_cuda);
  m.impl("i8_ln_quant_static", &i8_ln_quant_static_cuda);
  m.impl("i8_quant_rows", &i8_quant_rows_cuda);
  m.impl("i8_gemm", &i8_gemm_cuda);
  m.impl("qkv_attention", &qkv_attention_cuda);
  m.impl("lbs_apply", &lbs_apply_cuda);
}

TORCH_LIBRARY_IMPL(hands_tpu_torch_aoti, Meta, m) {
  m.impl("vit_layernorm", &same_meta);
  m.impl("vit_gemm", &vit_gemm_meta);
  m.impl("vit_attention", &vit_attention_meta);
  m.impl("i8_ln_quant_dynamic", &i8_ln_quant_dynamic_meta);
  m.impl("i8_ln_quant_static", &i8_ln_quant_static_meta);
  m.impl("i8_quant_rows", &rows_and_scales_meta);
  m.impl("i8_gemm", &i8_gemm_meta);
  m.impl("qkv_attention", &qkv_attention_meta);
  m.impl("lbs_apply", &lbs_apply_meta);
}
