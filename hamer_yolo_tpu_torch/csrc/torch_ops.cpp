// K1 and K2 as operators of PyTorch's dispatcher, namespace hyt_port.
//
// Host code, built by g++ (ops/torch_ops.py), never by nvcc. It declares the
// two schemas and registers their CUDA implementations, which launch the
// kernels through the plain C entry points of csrc/nms.cu (hyt_nms_keep),
// csrc/attn_block.cu (hyt_k2_weight_map, hyt_ln_qkv) and
// csrc/short_attention.cu (hyt_short_attention), the libraries
// ops/cuda_build.py builds: this library links them. The Python wrappers
// (ops/nms.greedy_nms_keep_mask, ops/attn_block.fused_bf16_attn_block) reach
// the same entry points through ctypes on the eager path; a program traced by
// torch.export, or compiled by AOTInductor and run from C++
// (csrc/deploy/aoti_runner.cpp), reaches them only through these operators,
// since a ctypes call on data pointers cannot be traced and is not there
// without Python. Shapes, dtypes and devices are checked as the Python
// wrappers check them; the launches are those of the wrappers, argument for
// argument, on the current stream of the tensors' device. The fakes and the
// CPU implementations (the plain versions) are registered from Python.
//
// Schemas: ops/torch_ops.SCHEMAS holds the same strings, and a test holds
// the two to each other.
#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/GradMode.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <array>
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

extern "C" {
int hyt_nms_keep(const void* boxes, const void* active, float thr, void* keep, int B, int K,
                 int bool_io, void* stream);
int hyt_k2_weight_map(const void* w, int K, int N, void* map);
int hyt_ln_qkv(const void* tok, int tok_f32, const void* wmap, const void* bias,
               const void* gamma, const void* beta, void* xhat, void* qkv, int M, int K, int N,
               void* stream);
int hyt_short_attention(const void* q, const void* k, const void* v, int in_f32, long long ib,
                        long long ih, long long in, void* out, int out_kind,
                        const void* out_scale, long long ob, long long oh, long long on, int B,
                        int H, int N, int hd, float scale, void* stream);
}

namespace {

constexpr int64_t kMaxK = 2048;  // ops/nms.MAX_K
constexpr int64_t kMaxHd = 128;  // ops/short_attention.MAX_HD

// The raw stream handle of the current stream of ``device``: what
// torch.cuda.current_stream(idx).cuda_stream gives the Python wrappers.
void* current_stream(const c10::Device& device) {
  return c10::impl::getDeviceGuardImpl(device.type())->getStream(device).native_handle();
}

// ops/cuda_build.refuse_grad: a kernel has no backward, so it refuses to run
// where autograd would track the call.
void refuse_grad(const char* what, std::initializer_list<const at::Tensor*> tensors) {
  if (!c10::GradMode::is_enabled()) return;
  for (const at::Tensor* t : tensors)
    TORCH_CHECK(!(t && t->defined() && t->requires_grad()), what,
                ": an input requires grad, and the kernel has no backward; call it under "
                "torch.no_grad() or run the plain layers");
}

void check_launch(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, ": CUDA error ", rc);
}

// ``t`` contiguous and 16-byte aligned (ops/cuda_build.aligned16).
at::Tensor aligned16(const at::Tensor& t) {
  at::Tensor c = t.contiguous();
  return reinterpret_cast<uintptr_t>(c.data_ptr()) % 16 ? c.clone() : c;
}

// --------------------------------------------------------------------- K1
at::Tensor greedy_nms_keep_mask_cuda(const at::Tensor& boxes, const at::Tensor& active,
                                     double iou_thres) {
  const char* what = "greedy_nms_keep";
  refuse_grad(what, {&boxes, &active});
  TORCH_CHECK(boxes.is_cuda(), what, ": unsupported device ", boxes.device());
  TORCH_CHECK(active.device() == boxes.device(), what, ": active on ", active.device(),
              ", boxes on ", boxes.device());
  TORCH_CHECK(boxes.dim() == 3 && boxes.size(2) == 4 && boxes.scalar_type() == at::kFloat &&
                  active.dim() == 2 && active.size(0) == boxes.size(0) &&
                  active.size(1) == boxes.size(1) && active.scalar_type() == at::kBool,
              what, ": boxes ", boxes.sizes(), " ", boxes.scalar_type(), ", active ",
              active.sizes(), " ", active.scalar_type(),
              "; the kernel takes f32 boxes (B, K, 4) and bool active (B, K)");
  const int64_t B = boxes.size(0), K = boxes.size(1);
  TORCH_CHECK(0 < K && K <= kMaxK, what, ": K=", K, " outside 1..", kMaxK,
              ", the kernel's limit");
  const c10::DeviceGuard guard(boxes.device());
  const at::Tensor b = boxes.contiguous(), a = active.contiguous();
  at::Tensor keep = at::empty({B, K}, a.options());
  check_launch(hyt_nms_keep(b.data_ptr(), a.data_ptr(), static_cast<float>(iou_thres),
                            keep.data_ptr(), static_cast<int>(B), static_cast<int>(K), 1,
                            current_stream(boxes.device())),
               "nms_keep_kernel");
  return keep;
}

// --------------------------------------------------------------------- K2
// The TMA map of a bf16 (K, N) weight: it encodes the address, the shape and
// the strides and nothing else, so it is kept by those (128 bytes of host
// memory a weight) and made again for any other.
std::array<char, 128> weight_map(const at::Tensor& w16) {
  static std::mutex mu;
  static std::map<std::tuple<int, uintptr_t, int64_t, int64_t>, std::array<char, 128>> maps;
  const auto key = std::make_tuple(static_cast<int>(w16.get_device()),
                                   reinterpret_cast<uintptr_t>(w16.data_ptr()), w16.size(0),
                                   w16.size(1));
  const std::lock_guard<std::mutex> lock(mu);
  const auto hit = maps.find(key);
  if (hit != maps.end()) return hit->second;
  std::array<char, 128> map{};
  check_launch(hyt_k2_weight_map(w16.data_ptr(), static_cast<int>(w16.size(0)),
                                 static_cast<int>(w16.size(1)), map.data()),
               "bf16_weight: the weight's TMA map");
  maps.emplace(key, map);
  return map;
}

// hd^-0.5 as JAX's weak typing rounds it next to bf16 q
// (ops/short_attention._scale: a Python float made a bf16 tensor).
float bf16_scale(int64_t hd) {
  return static_cast<float>(c10::BFloat16(static_cast<float>(std::pow(double(hd), -0.5))));
}

at::Tensor fused_bf16_attn_block_cuda(const at::Tensor& tok, const at::Tensor& w,
                                      const std::optional<at::Tensor>& bias,
                                      const at::Tensor& ln_scale, const at::Tensor& ln_bias,
                                      int64_t num_heads) {
  const char* what = "fused_bf16_attn_block";
  refuse_grad(what, {&tok, &w, bias.has_value() ? &*bias : nullptr, &ln_scale, &ln_bias});
  TORCH_CHECK(tok.is_cuda(), what, ": unsupported device ", tok.device());
  TORCH_CHECK(tok.scalar_type() == at::kBFloat16 || tok.scalar_type() == at::kFloat, what,
              ": the kernel takes bf16 or f32 tokens, got ", tok.scalar_type());
  TORCH_CHECK(tok.dim() == 3 && w.dim() == 2 && num_heads > 0, what,
              ": tok (B, N, K) and w (K, 3D), got ", tok.sizes(), " and ", w.sizes());
  const int64_t B = tok.size(0), N = tok.size(1), K = tok.size(2), td = w.size(1);
  const int64_t hd = td / 3 / num_heads, D = num_heads * hd;
  const bool has_bias = bias.has_value() && bias->defined();
  TORCH_CHECK(w.size(0) == K && td == 3 * D && K % 8 == 0 && hd % 8 == 0 &&
                  ln_scale.dim() == 1 && ln_scale.size(0) == K && ln_bias.dim() == 1 &&
                  ln_bias.size(0) == K && (!has_bias || (bias->dim() == 1 && bias->size(0) == td)),
              what, ": unsupported shapes tok ", tok.sizes(), ", w ", w.sizes(), ", heads ",
              num_heads, ", LN ", ln_scale.sizes(), ", ", ln_bias.sizes());
  TORCH_CHECK(w.device() == tok.device() && ln_scale.device() == tok.device() &&
                  ln_bias.device() == tok.device() && (!has_bias || bias->device() == tok.device()),
              what, ": every tensor must be on ", tok.device());
  TORCH_CHECK(hd <= kMaxHd, what, ": hd = ", hd, " is beyond the bf16 kernel's limit of hd <= ",
              kMaxHd);
  const c10::DeviceGuard guard(tok.device());
  void* stream = current_stream(tok.device());
  const at::Tensor x = aligned16(tok.reshape({B * N, K}));
  const at::Tensor w16 = aligned16(w.to(at::kBFloat16));
  const auto map = weight_map(w16);
  const auto f32 = tok.options().dtype(at::kFloat);
  const at::Tensor b32 = has_bias ? aligned16(bias->to(at::kFloat)) : at::zeros({td}, f32);
  const at::Tensor g32 = aligned16(ln_scale.to(at::kFloat));
  const at::Tensor bt32 = aligned16(ln_bias.to(at::kFloat));
  const auto bf16 = tok.options().dtype(at::kBFloat16);
  at::Tensor xhat = at::empty({B * N, K}, bf16);  // the LN output
  at::Tensor qkv = at::empty({B * N, td}, bf16);
  check_launch(hyt_ln_qkv(x.data_ptr(), tok.scalar_type() == at::kFloat, map.data(),
                          b32.data_ptr(), g32.data_ptr(), bt32.data_ptr(), xhat.data_ptr(),
                          qkv.data_ptr(), static_cast<int>(B * N), static_cast<int>(K),
                          static_cast<int>(td), stream),
               "fused_bf16_attn_block: qkv_gemm_kernel");
  at::Tensor out = at::empty({B, N, D}, tok.options());
  // q, k and v of head t at columns t hd, D + t hd and 2 D + t hd of qkv:
  // (B, h, N, hd) views with strides (N 3D, hd, 3D, 1); the output a
  // (B, h, N, hd) view of (B, N, D), strides (N D, hd, D, 1).
  const char* base = static_cast<const char*>(qkv.data_ptr());
  const int64_t col = D * static_cast<int64_t>(sizeof(c10::BFloat16));
  check_launch(hyt_short_attention(base, base + col, base + 2 * col, 0, N * td, hd, td,
                                   out.data_ptr(), tok.scalar_type() == at::kFloat ? 1 : 0,
                                   nullptr, N * D, hd, D, static_cast<int>(B),
                                   static_cast<int>(num_heads), static_cast<int>(N),
                                   static_cast<int>(hd), bf16_scale(hd), stream),
               "fused_bf16_attn_block: short_attention_kernel");
  return out;
}

}  // namespace

TORCH_LIBRARY(hyt_port, m) {
  m.def("greedy_nms_keep_mask(Tensor boxes, Tensor active, float iou_thres) -> Tensor");
  m.def("fused_bf16_attn_block(Tensor tok, Tensor w, Tensor? bias, Tensor ln_scale, "
        "Tensor ln_bias, int num_heads) -> Tensor");
}

TORCH_LIBRARY_IMPL(hyt_port, CUDA, m) {
  m.impl("greedy_nms_keep_mask", &greedy_nms_keep_mask_cuda);
  m.impl("fused_bf16_attn_block", &fused_bf16_attn_block_cuda);
}
