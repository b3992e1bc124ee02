// Single-block softmax attention over short sequences, bf16 or f32 in, bf16,
// f32 or int8 out: kernels K7 and K8, and the attention launch of K2, K3 and
// K6.
//
// Replaces the TPU kernels
// hamer_yolo_tpu/ops/attention_pallas.py:fused_short_attention
// (_attn_kernel) and :fused_qkv_attention (_attn_qkv_kernel): per (crop,
// head), softmax((q * scale) k^T) v with q * scale rounded to q's dtype, f32
// logits, max-subtracted exp, one reciprocal per row, p rounded to v's dtype
// before p.v with f32 accumulation; the output rounded once to bf16 or f32,
// or, with a static scale (out_scale), quantized in the epilogue to int8:
// clip(rint(o * (1 / s)), +-127). The same math is the attention of K2
// (fused_bf16_attn_block, output in the tokens' dtype), of K3
// (fused_int8_attn_proj_block, int8 by 1 / sx_proj) and of K6
// (fused_int8_attn_block, the same); their wrappers launch this kernel on
// views of their bf16 qkv buffers. K7 (hyt_short_attention) takes q, k and v
// through one stride set; K8 (hyt_fused_qkv_attention) takes the fused (B, N,
// 3D) tensor and the head count and derives each head's q, k and v offsets
// (s * D + t * hd) itself, writing a contiguous (B, N, D) output: on the TPU
// that saves four transposes through device memory, here both entries run
// the same device code on the same addresses. ViT-H: 16 crops x 16 heads,
// N = 192, hd = 80.
//
// What bounds it on the H100: per ViT-H layer the two products are 3.0 GFLOP
// in bf16 (3.1 us at the tensor cores' peak) against 31.5 MB of q, k, v and
// output (9.4 us at 3.35 TB/s), so it is bound by bytes, and by the latency
// of getting them on chip: each CTA's work is small.
//
// bf16 inputs, the design for Hopper (sm_90a): one CTA of three warpgroups
// (384 threads) per (192 query rows, head, crop), each warpgroup owning a
// 64-row query tile; at N = 192 that is one CTA per (head, crop).
// - q, k and v are read through (crop, head, row) strides, so a wrapper
//   hands in views of a fused (B, N, 3D) qkv buffer without a transpose
//   copy. The three Q tiles and the head's K and V land in shared memory by
//   16-byte cp.async (rows past N and columns past hd zero-filled by the
//   copy itself), never through registers, and K and V once for all three
//   tiles. Q + K complete one mbarrier and V a second, so the logits'
//   product starts while V is still in flight. Shared memory:
//   (2 * Nk + 192) * Hp * 2 bytes, Nk = N rounded up to 64, Hp = hd rounded
//   up to 16: 92 KB at N = 192, hd = 80 (the kernel this replaced staged f32
//   logits and bf16 probabilities there too, 142 KB for one 64-row tile).
//   With 106-168 registers a thread, one CTA (12 warps) runs on an SM.
//   Measured against it at the main path's shape (H100, CUDA graph replay, in turns
//   in one process): one warpgroup per CTA (three CTAs an SM, each loading
//   K and V from L2) read 0.0455 ms against 0.0350; persistent CTAs that
//   prefetch the next head into a second stage of shared memory read
//   0.0366 against 0.0350 (and spilled at N = 256), so the loads are not
//   what holds it back.
// - Operands sit in wgmma's unswizzled core-matrix layout: 8 rows x 16
//   bytes contiguous (128 B), core matrices along hd 128 B apart, groups of
//   8 rows Hp * 16 B apart. The same layout serves K as a K-major B operand
//   and V as an MN-major (transposed) one, so V needs no transpose pass.
// - The Q tile is scaled in place (q * scale rounded to bf16), then
//   S = Q K^T runs on wgmma.m64n64k16 from shared memory, Nk / 64
//   accumulators of 64 x 64 f32: the logits stay in registers (96 a thread
//   at N = 192).
// - The softmax runs on those registers: each row lives in the 4 threads of
//   a quad, so its max and sum take two shuffles each; padded keys get p = 0
//   (the mask is compiled away when N fills the accumulators, as N = 192
//   does). p is rounded to bf16 and packed straight into the A fragments of
//   the second product (the accumulator layout of m64nNk16 is the
//   A-register layout of the next k16 step).
// - O = P V runs on wgmma.m64n16k16 in the RS form (P from registers, V from
//   shared memory, transposed), one 64 x 16 f32 accumulator per 16 columns
//   of hd: 40 registers a thread at hd = 80. This part and the epilogue are
//   compiled for each of the 8 padded widths (a switch on Hp / 16), so no
//   wgmma sits behind a runtime guard: with guards ptxas fenced every one of
//   them, and the key mask and the guards together cost 14% (0.0352 ms
//   against 0.0304 at the main path's shape, measured as above). The price:
//   66 s of nvcc for this file, and the kernels for N > 192 (four logit
//   accumulators) spill about 230 bytes a thread.
// - The epilogue transposes each quad's accumulators by shuffles, so one
//   thread holds 8 adjacent columns of a row, and writes them with one
//   16-byte store (bf16), two (f32) or one 8-byte store (int8, quantize()
//   from common.cuh), through the output strides.
// This single-pass kernel takes N up to MAX_N1 = 256 keys (four n64
// accumulators); beyond, the key-block kernel (attention_bf16_long_kernel
// below) streams K and V through shared memory in blocks of 64 keys, in two
// passes that keep the rounding contract. hd is a multiple of 8 up to 128 in
// both. Elementwise steps use the _rn intrinsics and expf, so no FMA
// contraction or fast exp changes a rounding that the plain version does in
// two steps.
//
// f32 inputs (the JAX kernels take any float dtype): both products in f32
// on the CUDA cores with explicit FMAs, p left in f32, a 64-row q tile and
// its outputs in shared memory, K and V in blocks of 64 keys (K rows padded
// by one float so the logits' reads are free of bank conflicts), two passes
// as the key-block kernel; one CTA of 256 threads per (query tile, head,
// crop), any N, 145 KB of shared memory at hd = 128. It is the slow and right
// form of a path the CLI does not take (its tokens are bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "short_attention.cuh"

namespace {

template <typename OutT>
Kernel bf16_kernel(int N) {
  const int nch = (N + 63) / 64;
  return nch == 1   ? attention_bf16_kernel<1, OutT>
         : nch == 2 ? attention_bf16_kernel<2, OutT>
         : nch == 3 ? attention_bf16_kernel<3, OutT>
                    : attention_bf16_kernel<4, OutT>;
}

// The key-block kernel for a head width of hd (hd <= MAX_HD).
Kernel bf16_long_kernel(int hd) {
  switch (round16(hd) / 16) {
    case 1: return attention_bf16_long_kernel<1>;
    case 2: return attention_bf16_long_kernel<2>;
    case 3: return attention_bf16_long_kernel<3>;
    case 4: return attention_bf16_long_kernel<4>;
    case 5: return attention_bf16_long_kernel<5>;
    case 6: return attention_bf16_long_kernel<6>;
    case 7: return attention_bf16_long_kernel<7>;
    default: return attention_bf16_long_kernel<8>;
  }
}

// The bf16 kernel for N keys, hd and out_kind (0 bf16, 1 f32, 2 int8): the
// single-pass kernel up to MAX_N1 keys, the key-block kernel beyond.
Kernel bf16_kernel_for(int N, int hd, int out_kind) {
  if (N > MAX_N1) return bf16_long_kernel(hd);
  return out_kind == 0 ? bf16_kernel<bf16>(N)
         : out_kind == 1 ? bf16_kernel<float>(N)
                         : bf16_kernel<int8_t>(N);
}

// in_f32: q, k, v are f32 (else bf16). out_kind 0 bf16 (bf16 inputs only),
// 1 f32, 2 int8. The output strides are multiples of 8 elements and the
// output 16-byte aligned (the bf16 kernel stores 8 elements at a time).
int dispatch(AttnArgs p, int in_f32, int out_kind, int B, int H, cudaStream_t st) {
  if (p.N <= 0 || p.hd <= 0 || B <= 0 || H <= 0 || p.hd % 8 || p.ib % 8 || p.ih % 8 ||
      p.in % 8 || p.ob % 8 || p.oh % 8 || p.on % 8 || (uintptr_t)p.out % 16 || out_kind < 0 ||
      out_kind > 2 || (out_kind == 2) != (p.out_scale != nullptr) || (in_f32 && out_kind == 0) ||
      (!in_f32 && p.hd > MAX_HD))
    return (int)cudaErrorInvalidValue;
  p.out_kind = out_kind;
  if (in_f32)
    return launch(out_kind == 2 ? attention_f32_kernel<int8_t> : attention_f32_kernel<float>, AT,
                  QT, p, 4, B, H, st);
  return launch(bf16_kernel_for(p.N, p.hd, out_kind), CT, TPC * QT, p, 2, B, H, st);
}

}  // namespace


extern "C" int hyt_short_attn_smem_bytes(int N, int hd, int elem) {
  return smem_bytes(N, hd, elem);
}

// The bf16 kernel for (N, hd, out_kind): its registers a thread and the
// CTAs that fit on one SM. Returns a cudaError_t.
extern "C" int hyt_short_attn_occupancy(int N, int hd, int out_kind, int* regs, int* ctas) {
  if (N <= 0 || hd <= 0 || hd > MAX_HD || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const Kernel k = bf16_kernel_for(N, hd, out_kind);
  const int smem = smem_bytes(N, hd, 2);
  cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, k, CT, smem);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return (int)err;
}

// K7. q, k, v: bf16, or f32 with in_f32, with the element strides (ib, ih, in)
// over (crop, head, row) and hd contiguous; out, written through (ob, oh,
// on): out_kind 0 bf16, 1 f32, 2 int8 quantized by 1 / *out_scale (a (1,)
// f32 on the device). hd % 8 == 0, the strides multiples of 8 and the
// pointers 16-byte aligned; with bf16 inputs hd <= 128.
extern "C" int hyt_short_attention(const void* q, const void* k, const void* v, int in_f32,
                                   long long ib, long long ih, long long in, void* out,
                                   int out_kind, const void* out_scale, long long ob,
                                   long long oh, long long on, int B, int H, int N, int hd,
                                   float scale, void* stream) {
  AttnArgs p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ib = ib;
  p.ih = ih;
  p.in = in;
  p.out = out;
  p.ob = ob;
  p.oh = oh;
  p.on = on;
  p.N = N;
  p.hd = hd;
  p.scale = scale;
  p.out_scale = (const float*)out_scale;
  return dispatch(p, in_f32, out_kind, B, H, (cudaStream_t)stream);
}

// K8. qkv: contiguous (B, N, 3D), D = H * hd, laid out (s, head, e) along its
// last axis as the qkv GEMM writes it: head t's q, k, v start at s * D +
// t * hd. out: contiguous (B, N, D), out_kind as above.
extern "C" int hyt_fused_qkv_attention(const void* qkv, int in_f32, void* out, int out_kind,
                                       const void* out_scale, int B, int N, int H, int hd,
                                       float scale, void* stream) {
  const long long D = (long long)H * hd;
  const size_t elem = in_f32 ? 4 : 2;
  AttnArgs p;
  p.q = qkv;
  p.k = (const char*)qkv + D * elem;
  p.v = (const char*)qkv + 2 * D * elem;
  p.ib = N * 3 * D;
  p.ih = hd;
  p.in = 3 * D;
  p.out = out;
  p.ob = N * D;
  p.oh = hd;
  p.on = D;
  p.N = N;
  p.hd = hd;
  p.scale = scale;
  p.out_scale = (const float*)out_scale;
  return dispatch(p, in_f32, out_kind, B, H, (cudaStream_t)stream);
}
