// W8A8 int8 GEMM core of kernels K3, K4, K5, K6 and K10, with its f32
// prologues and dequantizing epilogues.
//
// Replaces the int8 GEMMs of the TPU kernels
//   hamer_yolo_tpu/ops/int8_matmul.py:fused_int8_matmul (K5; _kernel: an
//     [ln | gelu | gelu_poly | id] prologue in f32, per-row dynamic or static
//     int8 quantize, int8 GEMM, (acc * sx) * sw + b; above FUSED_GEMM_MAX_M
//     rows its XLA chain, _xla_chain: the quantize launch's CHAIN form and
//     the EPI_CHAIN_F32 / EPI_CHAIN_BF16 epilogues below),
//   hamer_yolo_tpu/ops/int8_matmul.py:fused_int8_mlp_block (K4; _mlp1_kernel:
//     LN, static quantize, fc1, acc * (s1 * sw) + b, GELU, quantize by s2;
//     _mlp2_kernel: fc2, acc * (s2 * sw) + b, + f32 residual),
//   hamer_yolo_tpu/ops/attention_pallas.py:fused_int8_attn_proj_block (K3's
//     qkv GEMM, acc * (sq * sw) + b -> bf16, and its proj GEMM,
//     (acc * sp) * pw + pb rounded to the token dtype, then + residual),
//   hamer_yolo_tpu/ops/attention_pallas.py:fused_int8_attn_block (K6: K3's
//     quantize and qkv GEMM),
//   hamer_yolo_tpu/ops/int8_matmul.py:fused_int8_mlp_block1 (K10;
//     _mlp1p_kernel: K4 in one call, see mlp_block1_kernel below).
//
// Two launches make each int8 product:
//  (a) quantize_rows_kernel: one warp per row. It computes the row's LN
//      statistics (two passes, as the plain version does), then the row's
//      absmax after the prologue (dynamic quantize), then writes the int8
//      row, x * (1 / scale) rounded half to even and clipped to +-127, and
//      the row's scale. The TPU kernel keeps this int8 block in VMEM; here
//      it goes through device memory once (M x K bytes), a known cost.
//  (b) int8_gemm_kernel, designed for Hopper (sm_90a): a persistent CTA
//      per SM walks 128 x 128 output tiles; K goes in 128-byte steps through
//      a 4-stage ring of shared-memory tiles that a producer warp fills with
//      TMA (cp.async.bulk.tensor on mbarriers, the 128-byte swizzle); two
//      MMA warpgroups run wgmma m64n128k32 s8 x s8 -> s32 (exact int32 sums)
//      from shared-memory descriptors, and two epilogue warpgroups dequantize
//      one tile while the next one's products run (see the kernel below).
//      8-bit wgmma reads both operands K-major only, so the kernel takes the
//      weight as a K-major (N, K) copy that the wrapper makes once per weight
//      (ops/int8_matmul.kmajor_weight), with its TMA map; the public
//      functions keep JAX's (K, N) layout. TMA's zero fill takes the ragged
//      M, N and K edges. Outputs and residuals move as 16-byte vectors.
//
// What bounds it on the H100: the ViT-H GEMMs at M = 3072-12288 rows (16-64
// crops x 192 tokens) are 10-161 G int8 ops against 5-80 MB of operands, so
// the tensor cores bound them (1,979 TOP/s int8 peak). What the design does
// about it: wgmma (mma.sync reaches a fraction of that rate); loads that run
// stages ahead of the products, and across tiles; no transpose on the way to
// shared memory; an epilogue that overlaps the next tile's products. Measured
// on an H100 at 700 W (PERF.md; chip_gemm.py): at M = 12288 the products alone
// run at 1,166-1,290 TOP/s, with the epilogue at 714-1,162: the GELU (fc1)
// and the residual (proj) keep the two epilogue warpgroups behind them.
//
// Rounding follows the plain versions in ops/int8_matmul.py and
// ops/attn_proj_block.py: every f32 step uses the _rn intrinsics (and the
// file is built with --fmad=false), so no FMA contraction changes a rounding
// the plain version does in two steps; the int32 -> f32 conversion rounds to
// nearest even; rsqrt is the correctly rounded __frsqrt_rn (not the
// approximate rsqrtf), as the plain version computes it; the exact GELU
// uses the A&S 7.1.26 erf of the TPU kernel. Where the JAX source divides by
// a constant (absmax / 127, x / sqrt 2, a mean's sum / K), its compiled
// program multiplies by the f32 reciprocal, and so do the kernel and the
// plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

enum Prologue { PRO_ID = 0, PRO_LN = 1, PRO_GELU = 2, PRO_GELU_POLY = 3 };
enum Epilogue {
  EPI_DEQ_ROW = 0,   // K5: (acc * sx) * sw + b, sx per row (dynamic) or static
  EPI_DEQ_FOLD = 1,  // K3 qkv: acc * (s * sw) + b
  EPI_GELU_Q = 2,    // K4 fc1: acc * (s * sw) + b -> GELU -> int8 by inv_out
  EPI_RESID = 3,     // K4 fc2: res + (acc * (s * sw) + b), added in f32
  EPI_PROJ = 4,      // K3 proj: res + to_out((acc * s) * sw + b), added in out dtype
  EPI_CHAIN_F32 = 5,   // K5's chain form: fma(acc, sx * sw, b) in f32
  EPI_CHAIN_BF16 = 6,  // the same under HYT_INT8_EP=bf16: each op rounded to bf16
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// erf by Abramowitz & Stegun 7.1.26, in the op order of
// int8_matmul._erf_f32 (the TPU kernel has no erf).
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(__fmul_rn(a5, t), a4);
  poly = __fadd_rn(__fmul_rn(poly, t), a3);
  poly = __fadd_rn(__fmul_rn(poly, t), a2);
  poly = __fadd_rn(__fmul_rn(poly, t), a1);
  poly = __fmul_rn(poly, t);
  return __fmul_rn(s, __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))));
}

// 0.5 x (1 + erf(x / sqrt 2)), as int8_matmul._prologue_f32("gelu") runs
// compiled: the division by the constant is a product with f32(1 / sqrt 2).
__device__ __forceinline__ float gelu_exact(float x) {
  constexpr float kRecipSqrt2 = 1.0f / 1.4142135623730951f;
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf_as(__fmul_rn(x, kRecipSqrt2))));
}

// The even-polynomial GELU of int8_matmul._gelu_poly_f32 (degree 8 in x^2).
__device__ __forceinline__ float gelu_poly(float x) {
  const float c[9] = {3.138923846637831e-05f, 0.3985892442238482f, -0.0658308598919238f,
                      0.009491168272223864f, -0.001005431695009259f, 7.497100545436031e-05f,
                      -3.6818665106501106e-06f, 1.0570036565177172e-07f,
                      -1.3327008826321846e-09f};
  const float u = fminf(__fmul_rn(x, x), 16.0f);
  float e = c[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) e = __fadd_rn(__fmul_rn(e, u), c[i]);
  const float y = __fadd_rn(__fmul_rn(0.5f, x), e);
  return x < -4.0f ? 0.0f : (x > 4.0f ? x : y);
}

// --------------------------------------- K5's chain form in the tokens' dtype
// JAX's _xla_chain (hamer_yolo_tpu/ops/int8_matmul.py) runs its prologue in
// the tokens' dtype: for bf16 tokens every op is an f32 op rounded to bf16
// (XLA's CPU code with excess precision off; the plain version,
// int8_matmul.chain_prologue_ref, is torch's bf16 ops), its constants rounded
// to bf16 first. rt<TokT> is that rounding (none for f32 tokens, whose
// prologue is the kernel form's).
template <typename TokT> __device__ __forceinline__ float rt(float v) { return v; }
template <> __device__ __forceinline__ float rt<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rb(float v) { return rt<bf16>(v); }

// The exact GELU of the chain on bf16 tokens, op by op as
// int8_matmul.chain_prologue_ref("gelu"): x / sqrt 2 is a true division by
// bf16(sqrt 2); expf is within 2 ulp of f32's exp, which the rounding to
// bf16 hides but where an f32 result lands within that of a bf16 midpoint.
__device__ __forceinline__ float gelu_chain_bf16(float x) {
  const float z = rb(__fdiv_rn(x, rb(1.4142135623730951f)));
  const float az = fabsf(z);
  const float t = rb(__fdiv_rn(1.0f, rb(__fadd_rn(1.0f, rb(__fmul_rn(rb(0.3275911f), az))))));
  float poly = rb(__fadd_rn(rb(__fmul_rn(rb(1.061405429f), t)), rb(-1.453152027f)));
  poly = rb(__fadd_rn(rb(__fmul_rn(poly, t)), rb(1.421413741f)));
  poly = rb(__fadd_rn(rb(__fmul_rn(poly, t)), rb(-0.284496736f)));
  poly = rb(__fadd_rn(rb(__fmul_rn(poly, t)), rb(0.254829592f)));
  poly = rb(__fmul_rn(poly, t));
  const float ex = rb(expf(rb(__fmul_rn(-az, az))));
  const float sg = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float erf = rb(__fmul_rn(sg, rb(__fsub_rn(1.0f, rb(__fmul_rn(poly, ex))))));
  return rb(__fmul_rn(rb(__fmul_rn(0.5f, x)), rb(__fadd_rn(1.0f, erf))));
}

// The polynomial GELU of the chain: JAX's coefficients are strong f32, so
// the polynomial runs in f32 with the multiply-adds that XLA's CPU code
// contracts (fmaf), on u = min(x * x, 16) rounded to the tokens' dtype; the
// result is f32 whatever the tokens.
template <typename TokT>
__device__ __forceinline__ float gelu_poly_chain(float x) {
  const float c[9] = {3.138923846637831e-05f, 0.3985892442238482f, -0.0658308598919238f,
                      0.009491168272223864f, -0.001005431695009259f, 7.497100545436031e-05f,
                      -3.6818665106501106e-06f, 1.0570036565177172e-07f,
                      -1.3327008826321846e-09f};
  const float u = fminf(rt<TokT>(__fmul_rn(x, x)), 16.0f);
  float e = c[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) e = __fmaf_rn(e, u, c[i]);
  const float y = __fadd_rn(__fmul_rn(0.5f, x), e);
  return x < -4.0f ? 0.0f : (x > 4.0f ? x : y);
}

// ------------------------------------------------------- (a) quantize rows
constexpr int QW = 8;  // rows (warps) per block

template <int PRO>
__device__ __forceinline__ float prologue(float x, float mu, float rstd, const float* g,
                                          const float* b, int k) {
  if constexpr (PRO == PRO_LN) return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), g[k]), b[k]);
  if constexpr (PRO == PRO_GELU) return gelu_exact(x);
  if constexpr (PRO == PRO_GELU_POLY) return gelu_poly(x);
  return x;
}

// The chain's prologue (CHAIN) on one value: for f32 tokens the kernel
// form's, except the polynomial GELU; for bf16 tokens op by op in bf16 (LN's
// mu and rstd already rounded to bf16).
template <typename TokT, int PRO, bool CHAIN>
__device__ __forceinline__ float prologue_of(float x, float mu, float rstd, const float* g,
                                            const float* b, int k) {
  if constexpr (CHAIN && PRO == PRO_GELU_POLY) return gelu_poly_chain<TokT>(x);
  if constexpr (!CHAIN || !std::is_same<TokT, bf16>::value) {
    return prologue<PRO>(x, mu, rstd, g, b, k);
  } else if constexpr (PRO == PRO_LN) {
    return rb(__fadd_rn(rb(__fmul_rn(rb(__fmul_rn(rb(__fsub_rn(x, mu)), rstd)), rb(g[k]))),
                        rb(b[k])));
  } else if constexpr (PRO == PRO_GELU) {
    return gelu_chain_bf16(x);
  } else {
    return x;
  }
}

// One warp quantizes one row xr (K values) into qr: the row's LN statistics
// (two passes), its absmax after the prologue where DYN, then the int8 values.
// Returns the row's scale. CHAIN: K5's chain form (JAX's _xla_chain): the
// prologue in the tokens' dtype (prologue_of), the bf16 LN's means rounded to
// bf16 and divided by K as torch.mean does; where the prologue's result is
// bf16, the scale max(f32(bf16(absmax / 127)), 1e-8) and the int8 value
// rint(bf16(x / bf16(scale))); where it is f32 (f32 tokens, the polynomial
// GELU), absmax times f32(1 / 127) and rint(x / scale), a true division.
template <typename TokT, int PRO, bool DYN, bool CHAIN>
__device__ __forceinline__ float quantize_row(const TokT* __restrict__ xr,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b, int K,
                                              const float* __restrict__ s_static,
                                              int8_t* __restrict__ qr, int lane) {
  constexpr bool BF16_LN = CHAIN && PRO == PRO_LN && std::is_same<TokT, bf16>::value;
  constexpr bool BF16_OUT = CHAIN && std::is_same<TokT, bf16>::value && PRO != PRO_GELU_POLY;
  float mu = 0.0f, rstd = 0.0f;
  if constexpr (BF16_LN) {
    float s = 0.0f;
    for (int k = lane; k < K; k += 32) s = __fadd_rn(s, to_f32(xr[k]));
    mu = rb(__fdiv_rn(warp_sum(s), (float)K));
    float v = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float d = rb(__fsub_rn(to_f32(xr[k]), mu));
      v = __fadd_rn(v, rb(__fmul_rn(d, d)));
    }
    const float var = rb(__fdiv_rn(warp_sum(v), (float)K));
    rstd = rb(__frsqrt_rn(rb(__fadd_rn(var, rb(1e-6f)))));
  } else if constexpr (PRO == PRO_LN) {
    const float inv_k = __fdiv_rn(1.0f, (float)K);  // means are sums times f32(1 / K)
    float s = 0.0f;
    for (int k = lane; k < K; k += 32) s = __fadd_rn(s, to_f32(xr[k]));
    mu = __fmul_rn(warp_sum(s), inv_k);
    float v = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float d = __fsub_rn(to_f32(xr[k]), mu);
      v = __fadd_rn(v, __fmul_rn(d, d));
    }
    const float var = __fmul_rn(warp_sum(v), inv_k);
    rstd = __frsqrt_rn(__fadd_rn(var, 1e-6f));
  }
  float scale;
  if constexpr (DYN) {
    float m = 0.0f;
    for (int k = lane; k < K; k += 32)
      m = fmaxf(m, fabsf(prologue_of<TokT, PRO, CHAIN>(to_f32(xr[k]), mu, rstd, g, b, k)));
    m = warp_max(m);
    scale = fmaxf(BF16_OUT ? rb(__fdiv_rn(m, 127.0f)) : __fmul_rn(m, 1.0f / 127.0f), 1e-8f);
  } else {
    scale = *s_static;
  }
  if constexpr (CHAIN) {
    const float sq = BF16_OUT ? rb(scale) : scale;
    for (int k = lane; k < K; k += 32) {
      float r = __fdiv_rn(prologue_of<TokT, PRO, CHAIN>(to_f32(xr[k]), mu, rstd, g, b, k), sq);
      r = rintf(BF16_OUT ? rb(r) : r);
      qr[k] = (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
    }
  } else {
    const float inv = __fdiv_rn(1.0f, scale);
    for (int k = lane; k < K; k += 32)
      qr[k] = quantize(prologue<PRO>(to_f32(xr[k]), mu, rstd, g, b, k), inv);
  }
  return scale;
}

template <typename TokT, int PRO, bool DYN, bool CHAIN>
__global__ void __launch_bounds__(QW * 32)
quantize_rows_kernel(const TokT* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, int M, int K,
                     const float* __restrict__ s_static, int8_t* __restrict__ xq,
                     float* __restrict__ row_scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QW + (threadIdx.x >> 5);
  if (row >= M) return;
  const float scale = quantize_row<TokT, PRO, DYN, CHAIN>(x + (size_t)row * K, g, b, K,
                                                          s_static, xq + (size_t)row * K, lane);
  if (DYN && lane == 0) row_scale[row] = scale;
}

template <typename TokT, int PRO, bool CHAIN>
int launch_quantize(const void* x, const float* g, const float* b, int M, int K, int dynamic,
                    const float* s, int8_t* xq, float* row_scale, cudaStream_t st) {
  const dim3 grid((M + QW - 1) / QW);
  if (dynamic)
    quantize_rows_kernel<TokT, PRO, true, CHAIN><<<grid, QW * 32, 0, st>>>(
        (const TokT*)x, g, b, M, K, s, xq, row_scale);
  else
    quantize_rows_kernel<TokT, PRO, false, CHAIN><<<grid, QW * 32, 0, st>>>(
        (const TokT*)x, g, b, M, K, s, xq, row_scale);
  return (int)cudaGetLastError();
}

template <typename TokT, bool CHAIN>
int dispatch_quantize(const void* x, const float* g, const float* b, int prologue, int M, int K,
                      int dynamic, const float* s, int8_t* xq, float* row_scale,
                      cudaStream_t st) {
  switch (prologue) {
    case PRO_ID:
      return launch_quantize<TokT, PRO_ID, CHAIN>(x, g, b, M, K, dynamic, s, xq, row_scale, st);
    case PRO_LN:
      return launch_quantize<TokT, PRO_LN, CHAIN>(x, g, b, M, K, dynamic, s, xq, row_scale, st);
    case PRO_GELU:
      return launch_quantize<TokT, PRO_GELU, CHAIN>(x, g, b, M, K, dynamic, s, xq, row_scale,
                                                    st);
    case PRO_GELU_POLY:
      return launch_quantize<TokT, PRO_GELU_POLY, CHAIN>(x, g, b, M, K, dynamic, s, xq,
                                                         row_scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------- epilogue arithmetic (K3-K6, K10)
// acc * (s * sw) + b: the dequant with the scales folded.
__device__ __forceinline__ float dequant_fold(int acc, float s, float sw, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(s, sw)), b);
}

// fc1's epilogue (K4, K10): dequant -> GELU -> int8 by inv_out.
__device__ __forceinline__ int8_t dequant_gelu_q(int acc, float s, float sw, float b, int poly,
                                                 float inv_out) {
  const float y = dequant_fold(acc, s, sw, b);
  return quantize(poly ? gelu_poly(y) : gelu_exact(y), inv_out);
}

// One output element of the GEMM: s the static scale (or this row's), sw
// and b the column's weight scale and bias, res the residual (EPI_RESID,
// EPI_PROJ), inv_out 1 / the int8 output's scale (EPI_GELU_Q).
template <int EPI, typename OutT>
__device__ __forceinline__ OutT epi_value(int acc, float s, float sw, float b, OutT res,
                                          float inv_out, int poly) {
  const float af = __int2float_rn(acc);
  if constexpr (EPI == EPI_DEQ_ROW) {
    return from_f32<OutT>(__fadd_rn(__fmul_rn(__fmul_rn(af, s), sw), b));
  } else if constexpr (EPI == EPI_DEQ_FOLD) {
    return from_f32<OutT>(dequant_fold(acc, s, sw, b));
  } else if constexpr (EPI == EPI_GELU_Q) {
    return dequant_gelu_q(acc, s, sw, b, poly, inv_out);
  } else if constexpr (EPI == EPI_RESID) {
    return from_f32<OutT>(__fadd_rn(to_f32(res), dequant_fold(acc, s, sw, b)));
  } else if constexpr (EPI == EPI_PROJ) {
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(af, s), sw), b);
    return from_f32<OutT>(__fadd_rn(to_f32(res), to_f32(from_f32<OutT>(y))));
  } else if constexpr (EPI == EPI_CHAIN_F32) {
    return from_f32<OutT>(__fmaf_rn(af, __fmul_rn(s, sw), b));
  } else {  // EPI_CHAIN_BF16
    return from_f32<OutT>(rb(__fadd_rn(rb(__fmul_rn(rb(af), rb(__fmul_rn(s, sw)))), rb(b))));
  }
}

// ----------------------------------------------------------- (b) int8 GEMM
constexpr int BM = 128, BN = 128;  // a CTA's output tile: two warpgroups of 64 x 128
constexpr int BK = 128;            // K bytes of a ring stage: one 128-byte swizzle row
constexpr int STAGES = 4;          // ring stages
constexpr int BOX_ROWS = 64;       // rows of one TMA box, of A and of the weight alike
constexpr int MMA_THREADS = 256, EPI_THREADS = 256;           // two warpgroups each
constexpr int GEMM_THREADS = MMA_THREADS + EPI_THREADS + 32;  // and the producer warp
constexpr int PITCH = BN * 4 + 16;  // bytes of a staged int32 row (16 of padding)
// Diagnostic builds only (chip_gemm.py --variant, outputs wrong): 1 leaves out
// the epilogue's arithmetic and stores, 2 the producer's TMA copies.
#ifndef HYT_GEMM_DIAG
#define HYT_GEMM_DIAG 0
#endif

struct GemmArgs {
  const float* row_scale;  // (M,) per-row scales, or null for the scalar s
  const float* wscale;     // (N,), 16-byte aligned
  const float* bias;       // (N,), 16-byte aligned
  const void* res;         // (M, N) residual in the output dtype (EPI_RESID, EPI_PROJ)
  void* out;               // (M, N)
  const float* s;          // (1,) static activation scale, used where row_scale is null
  const float* out_scale;  // (1,) scale of the int8 output (EPI_GELU_Q)
  int gelu_poly;           // EPI_GELU_Q: the polynomial GELU (else exact)
  int M, N, K;
};

// Dynamic shared memory of a CTA, from a 1024-byte aligned base: the ring
// (STAGES x (A 128 x 128 B, B 128 x 128 B)), two staging tiles of 64 x 128
// int32 (one per MMA warpgroup), then the mbarriers.
struct GemmLayout {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int STAGING = STAGES * STAGE_BYTES;
  static constexpr int BARS = STAGING + 2 * 64 * PITCH;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 4) + 1024;  // + room to align
};

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fence, commit and wait around them.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N s32) += A (64 x 32 s8) . B (N x 32 s8)^T: wgmma from shared
// memory, both operands K-major (8-bit wgmma has no transpose), exact int32
// sums.
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// CV output columns of one row from the staged int32 accumulators at a
// (16-byte aligned), with the columns' weight scales sw, biases b and the
// residual r: epi_value on each, written to out as 16-byte vectors.
template <int EPI, typename OutT, int CV, bool POLY>
__device__ __forceinline__ void epilogue_vector(const int* a, const float (&sw)[CV],
                                                const float (&b)[CV], const OutT (&r)[CV],
                                                OutT* out, float s, float inv_out) {
  alignas(16) int acc[CV];
  alignas(16) OutT o[CV];
#pragma unroll
  for (int i = 0; i < CV; i += 4)
    *reinterpret_cast<int4*>(acc + i) = *reinterpret_cast<const int4*>(a + i);
#pragma unroll
  for (int i = 0; i < CV; ++i)
    o[i] = epi_value<EPI, OutT>(acc[i], s, sw[i], b[i], r[i], inv_out, POLY);
#pragma unroll
  for (int i = 0; i < CV * (int)sizeof(OutT); i += 16)
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(out) + i) =
        *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(o) + i);
}

// The kernel. One CTA per SM (at most one per output tile) walks output
// tiles of 128 x 128: tile blockIdx.x + i * gridDim.x, n fastest, so that
// the CTAs at work share A's rows and the weight in L2. Four roles:
// - a producer warp (its first lane) fills the ring with TMA for tile after
//   tile: it waits for a stage's empty barrier, announces the stage's bytes
//   on its full barrier and issues the copies (A: two 64-row boxes, the
//   weight: two), which complete on that barrier;
// - two MMA warpgroups, 64 rows of the tile each, wait on the full barrier,
//   issue four wgmma m64n128k32 on the stage, commit them and, once the
//   group before has retired (wait_group 1), release that stage with one
//   arrival each; after the tile's last stage they write their int32
//   accumulators to their staging tile and go on to the next tile;
// - two epilogue warpgroups turn the staged tiles into outputs while the
//   next tile's products run.
// Each MMA warpgroup and its epilogue warpgroup pass their staging tile back
// and forth on two mbarriers (staged, drained). The producer and the MMA
// warpgroups count ring uses across tiles, so stage and phase carry over.
// Waves on 132 SMs: ViT-H's N = 1280 at M = 3072 is 240 tiles (the second
// round 108 CTAs), at M = 12288 960 (7.3 a CTA); N = 3840 and 5120 at M =
// 12288 are 2880 and 3840 tiles.
//
// Shared memory: 128 KB of ring and 66 KB of staging, 195 KB; one CTA of
// 17 warps an SM, at most 120 registers a thread (the MMA warpgroups hold
// 64 accumulators). No setmaxnreg: the producer is a single warp.

// An epilogue warpgroup's share of each tile: 64 rows x 128 columns of
// int32 in its staging tile. Thread t always takes the same CV columns (its
// weight scales and biases load once a tile) of rows t / VPR + RSTEP k, k <
// ITERS; with a residual, all of its ITERS residual vectors are loaded
// before any is used, so the loads' latency is paid once a tile.
template <int EPI, typename OutT, bool POLY>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& p, const uint8_t* stage,
                                              uint64_t* staged, uint64_t* drained, int wg, int t,
                                              int nt, int tiles) {
  constexpr int CV = sizeof(OutT) == 1 ? 16 : 8;  // 16 bytes of bf16 or int8, 32 of f32
  constexpr int VPR = BN / CV;                     // vectors a row
  constexpr int RSTEP = 128 / VPR, ITERS = 64 / RSTEP;
  constexpr bool RES = EPI == EPI_RESID || EPI == EPI_PROJ;
  const float s_static = p.row_scale ? 0.0f : *p.s;
  float inv_out = 0.0f;
  if constexpr (EPI == EPI_GELU_Q) inv_out = __fdiv_rn(1.0f, *p.out_scale);
  const int c = (t % VPR) * CV, rt = t / VPR;
  int n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const int row0 = tile / nt * BM + wg * 64, col = tile % nt * BN + c;
    const bool col_ok = col < p.N;  // N is a multiple of 16: no vector crosses it
    alignas(16) float w[CV], b[CV];
    alignas(16) OutT res[RES ? ITERS : 1][CV] = {};
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < CV; i += 4) {
        *reinterpret_cast<float4*>(w + i) = *reinterpret_cast<const float4*>(p.wscale + col + i);
        *reinterpret_cast<float4*>(b + i) = *reinterpret_cast<const float4*>(p.bias + col + i);
      }
      if constexpr (RES) {
#pragma unroll
        for (int k = 0; k < ITERS; ++k) {
          const int row = row0 + rt + RSTEP * k;
          if (row < p.M) {
            const uint8_t* src = reinterpret_cast<const uint8_t*>(
                static_cast<const OutT*>(p.res) + (size_t)row * p.N + col);
#pragma unroll
            for (int i = 0; i < CV * (int)sizeof(OutT); i += 16)
              *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(res[k]) + i) =
                  *reinterpret_cast<const uint4*>(src + i);
          }
        }
      }
    }
    mbar_wait(smem_u32(staged), n & 1);
#pragma unroll(EPI == EPI_GELU_Q ? 1 : ITERS)
    for (int k = 0; k < ITERS; ++k) {
      const int r = rt + RSTEP * k, row = row0 + r;
      if (HYT_GEMM_DIAG == 1 || !col_ok || row >= p.M) continue;
      epilogue_vector<EPI, OutT, CV, POLY>(
          reinterpret_cast<const int*>(stage + r * PITCH) + c, w, b, res[RES ? k : 0],
          static_cast<OutT*>(p.out) + (size_t)row * p.N + col,
          p.row_scale ? p.row_scale[row] : s_static, inv_out);
    }
    mbar_arrive(smem_u32(drained));
  }
}

template <int EPI, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap, const GemmArgs p) {
  using L = GemmLayout;
  extern __shared__ __align__(16) uint8_t gemm_smem_raw[];
  uint8_t* smem = gemm_smem_raw + ((1024 - (smem_u32(gemm_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* staged = empty + STAGES;  // [2]: a staging tile holds accumulators
  uint64_t* drained = staged + 2;     // [2]: its epilogue is done with it
  const int tid = threadIdx.x;
  const int nt = (p.N + BN - 1) / BN, tiles = (p.M + BM - 1) / BM * nt;
  const int KT = (p.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2);  // one arrival per MMA warpgroup
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(smem_u32(staged + w), 128);
      mbar_init(smem_u32(drained + w), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= MMA_THREADS + EPI_THREADS) {  // the producer warp
    if (tid == MMA_THREADS + EPI_THREADS) {
      int it = 0;  // ring uses so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / nt * BM, n0 = tile % nt * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(smem_u32(empty + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t bar = smem_u32(full + s);
          mbar_arrive_expect_tx(bar, HYT_GEMM_DIAG == 2 ? 0 : L::STAGE_BYTES);
          if (HYT_GEMM_DIAG == 2) continue;
          const uint32_t a = smem_u32(smem + s * L::STAGE_BYTES), b = a + L::A_BYTES;
#pragma unroll
          for (int r = 0; r < BM; r += BOX_ROWS) tma_load(a + r * BK, &amap, kt * BK, m0 + r, bar);
#pragma unroll
          for (int r = 0; r < BN; r += BOX_ROWS)
            tma_load(b + r * BK, &wmap, kt * BK, n0 + r, bar);
        }
      }
    }
    return;
  }

  if (tid >= MMA_THREADS) {  // the epilogue warpgroups
    const int wg = (tid - MMA_THREADS) >> 7;
    const uint8_t* stage = smem + L::STAGING + wg * 64 * PITCH;
    if (EPI == EPI_GELU_Q && p.gelu_poly)
      gemm_epilogue<EPI, OutT, true>(p, stage, staged + wg, drained + wg, wg, tid & 127, nt,
                                     tiles);
    else
      gemm_epilogue<EPI, OutT, false>(p, stage, staged + wg, drained + wg, wg, tid & 127, nt,
                                      tiles);
    return;
  }

  // the MMA warpgroups
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  uint8_t* stage = smem + L::STAGING + wg * 64 * PITCH;
  int it = 0, n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(full + s), (it / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * L::STAGE_BYTES);
      const uint64_t da = sw128_desc(a + wg * 64 * BK), db = sw128_desc(a + L::A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && t == 0) mbar_arrive(smem_u32(empty + (it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (t == 0) mbar_arrive(smem_u32(empty + (it - 1) % STAGES));  // the tile's last stage
    // hand the accumulators over, once the epilogue is done with the last ones
    mbar_wait(smem_u32(drained + wg), (n & 1) ^ 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(stage + (warp * 16 + h * 8 + g) * PITCH + (j * 8 + q * 2) * 4) =
            make_int2(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1]);
    mbar_arrive(smem_u32(staged + wg));
  }
}

template <int EPI, typename OutT>
int launch_gemm(const CUtensorMap& amap, const CUtensorMap& wmap, const GemmArgs& p,
                cudaStream_t st) {
  auto kernel = int8_gemm_kernel<EPI, OutT>;
  static bool smem_set[MAX_DEVICES] = {};  // the shared-memory limit raised on the device
  int dev = 0, sms = 0;
  if (const int rc = current_sms(&dev, &sms)) return rc;
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GemmLayout::BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const int tiles = (p.M + BM - 1) / BM * ((p.N + BN - 1) / BN);
  kernel<<<tiles < sms ? tiles : sms, GEMM_THREADS, GemmLayout::BYTES, st>>>(amap, wmap, p);
  return (int)cudaGetLastError();
}

int dispatch_gemm(int epi, int out_kind, const CUtensorMap& amap, const CUtensorMap& wmap,
                  const GemmArgs& p, cudaStream_t st) {
  const bool f32 = out_kind == 1;
  switch (epi) {
    case EPI_DEQ_ROW:
      return f32 ? launch_gemm<EPI_DEQ_ROW, float>(amap, wmap, p, st)
                 : launch_gemm<EPI_DEQ_ROW, bf16>(amap, wmap, p, st);
    case EPI_DEQ_FOLD:
      return f32 ? launch_gemm<EPI_DEQ_FOLD, float>(amap, wmap, p, st)
                 : launch_gemm<EPI_DEQ_FOLD, bf16>(amap, wmap, p, st);
    case EPI_GELU_Q: return launch_gemm<EPI_GELU_Q, int8_t>(amap, wmap, p, st);
    case EPI_RESID:
      return f32 ? launch_gemm<EPI_RESID, float>(amap, wmap, p, st)
                 : launch_gemm<EPI_RESID, bf16>(amap, wmap, p, st);
    case EPI_PROJ:
      return f32 ? launch_gemm<EPI_PROJ, float>(amap, wmap, p, st)
                 : launch_gemm<EPI_PROJ, bf16>(amap, wmap, p, st);
    case EPI_CHAIN_F32:
      return f32 ? launch_gemm<EPI_CHAIN_F32, float>(amap, wmap, p, st)
                 : launch_gemm<EPI_CHAIN_F32, bf16>(amap, wmap, p, st);
    case EPI_CHAIN_BF16:
      return f32 ? launch_gemm<EPI_CHAIN_BF16, float>(amap, wmap, p, st)
                 : launch_gemm<EPI_CHAIN_BF16, bf16>(amap, wmap, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The TMA map of a K-major (rows, K) int8 matrix at base: boxes of 64 rows
// x 128 bytes, the 128-byte swizzle, zeros past the edges.
int encode_kmajor(CUtensorMap* map, const void* base, int rows, int K) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, K, BOX_ROWS, BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// ------------------------------------------- K10: the int8 MLP in one launch
// quantize_row<TokT, PRO_LN, false> on a row's values (at most 32 NV)
// loaded into registers first, all at once (load_row), with the LN's scale
// and bias g, b read from shared memory: one load latency a row where quantize_row pays
// three passes of dependent loads (its launch hides them behind many rows an
// SM; a K10 CTA has 8 rows at ViT-H for its 14 warps). The same values in
// the same lanes, summed and rounded in the same order, so the same int8
// row.
// The row xr's values of this lane, k = lane + 32 i, as f32 (0 past K).
template <typename TokT, int NV>
__device__ __forceinline__ void load_row(float (&v)[NV], const TokT* __restrict__ xr, int K,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    v[i] = k < K ? to_f32(xr[k]) : 0.0f;
  }
}

template <int NV>
__device__ __forceinline__ void quantize_row_ln_regs(const float (&v)[NV],
                                                     const float* __restrict__ g,
                                                     const float* __restrict__ b, int K,
                                                     float scale, int8_t* __restrict__ qr,
                                                     int lane) {
  const float inv_k = __fdiv_rn(1.0f, (float)K);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < K) s = __fadd_rn(s, v[i]);
  const float mu = __fmul_rn(warp_sum(s), inv_k);
  float var = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < K) {
      const float d = __fsub_rn(v[i], mu);
      var = __fadd_rn(var, __fmul_rn(d, d));
    }
  const float rstd = __frsqrt_rn(__fadd_rn(__fmul_rn(warp_sum(var), inv_k), 1e-6f));
  const float inv = __fdiv_rn(1.0f, scale);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    if (k < K) qr[k] = quantize(prologue<PRO_LN>(v[i], mu, rstd, g, b, k), inv);
  }
}

// fused_int8_mlp_block1 (_mlp1p_kernel): LN + quantize (s1) + fc1 + GELU +
// quantize (s2) + fc2 + dequant + f32 residual, H taken in chunks with the
// fc2 partial sums added in int32, so the result is bit-identical to K4's
// launches: the same quantize_row, the same exact int32 sums, the same
// dequant_gelu_q and residual arithmetic (K4's EPI_GELU_Q and EPI_RESID).
//
// What bounds it on the H100: the same 80.5 G int8 operations as K4 at
// ViT-H's M = 3072, so the tensor cores (0.0407 ms at the 1,979 TOP/s peak).
// The difficulty is fc2's accumulator: a tile of BM token rows needs BM x K
// int32 of it for the whole kernel (327 KB at BM = 64, K = 1280), more than
// one SM holds. The design, for this card:
// - A thread-block cluster of C CTAs owns 64 token rows; CTA rank r owns
//   fc2's output columns [160 r, 160 r + 160), so its share of the
//   accumulator (64 x 160 int32) lives in the registers of one warpgroup.
//   C = ceil(K / 160), up to 8 at K = 1280 (the host chooses it:
//   ops/int8_matmul.mlp1_cluster).
// - The CTAs share the LN + quantize of the 64 rows (rows r, r + C, ...
//   each), with quantize_row's arithmetic, and write each int8 row into
//   X (64 x K, laid out as the 128-byte swizzle that wgmma reads) of every
//   CTA of the cluster through distributed shared memory.
// - H goes in chunks of 64 C columns. Per chunk, CTA r computes fc1's 64
//   columns [64 r, 64 r + 64) of the chunk (wgmma m64n64k32 s8 on X and a
//   TMA-fed ring of w1 tiles), dequantizes, GELUs and requantizes them by s2
//   (dequant_gelu_q), and writes that int8 slice into the chunk buffer of
//   every CTA of the cluster with asynchronous stores (st.async) that count
//   as transaction bytes on the buffer's mbarrier in the receiving CTA, so
//   the writer neither fences nor waits for them. Then each CTA
//   runs fc2 for its 160 columns over the whole chunk (wgmma m64n160k32 s8
//   on the chunk and a TMA-fed ring of w2 tiles) and tells every CTA that it
//   is done with the buffer.
// - Roles: two fc1 warpgroups take the chunks in turns (even, odd), each
//   with its own chunk buffer, so that one's GELU and exchange overlap the
//   other's products; one warpgroup runs fc2 and the final epilogue; one
//   producer warp each keeps the w1 ring and the w2 ring full.
// - The weights come K-major through the TMA maps of their K-major copies
//   (ops/int8_matmul.kmajor_weight; the same maps as K4's GEMMs): w1 as
//   (H, K), w2 as (K, H). TMA's zero fill takes the ragged H, K and chunk
//   edges; GELU values past H are written as 0.
// - The final dequant + residual goes through shared memory (the rings,
//   free by then), so the residual comes in and the output goes out as
//   coalesced 16-byte vectors.
// Each cluster reads each weight once (13.1 MB at ViT-H), M / 64 times a
// launch: 630 MB from L2 at M = 3072, where K4's 128-row tiles read 315
// MB; shared memory (X alone is 80 KB at K = 1280) leaves no room for a
// taller tile. The (M, H) int8 tensor that K4 writes and reads back never
// exists. Measured on an H100 (PERF.md; chip_gemm.py --k10): about twice
// K4's time; neither the loads nor either product alone holds it back
// (--variant noload, nofc1, nofc2 gain under 10%): a CTA's time goes to the
// LN and set-up, the per-chunk chain of GELU, exchange and the cluster's
// lockstep, and the final epilogue, and only 15 clusters of 8 fit at once.
constexpr int M1_BM = 64;         // token rows of a cluster (one wgmma M)
constexpr int M1_FW = 64;         // fc1 columns of a CTA in each chunk
constexpr int M1_NC = 160;        // fc2 output columns of a CTA
constexpr int M1_MAX_K = 1280;    // 8 CTAs x 160 columns
constexpr int M1_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int M1_S1 = 4, M1_S2 = 2;         // stages of the w1 and w2 rings
constexpr int M1_TILE = M1_BM * 128;        // a 64-row block of 128 swizzled bytes
constexpr int M1_W2_STAGE = 3 * M1_TILE;    // three 64-row boxes of w2 (160 rows used)
constexpr int M1_SLICE = M1_BM * M1_FW;     // bytes of a CTA's GELU slice of a chunk
constexpr int M1_THREADS = 3 * 128 + 64;    // three warpgroups and two producer warps
// Diagnostic builds only (chip_gemm.py --k10 --variant, outputs wrong): 1
// leaves out the GELU epilogue and the final epilogue, 2 the producers' TMA
// copies, 3 the stores to the other CTAs' chunk buffers, 4 the LN and
// quantize of the rows; 5 writes the SM clock at the steps of the first CTA
// over its tokens (the input), as int64 slots (K10_STAMP); 6 and 7 leave out
// fc1's and fc2's products, 8 the final epilogue.
#ifndef HYT_K10_DIAG
#define HYT_K10_DIAG 0
#endif
#if HYT_K10_DIAG == 5
#define K10_STAMP(slot)                                                          \
  do {                                                                           \
    if (blockIdx.x == 0 && blockIdx.y == 0)                                      \
      reinterpret_cast<long long*>(const_cast<void*>(p.x))[slot] = clock64();   \
  } while (0)
// and every CTA its start and end on the global timer (ns) and its SM,
// from slot 128 on, three slots a CTA
#define K10_SPAN(i)                                                              \
  do {                                                                           \
    long long* o_ = reinterpret_cast<long long*>(const_cast<void*>(p.x)) + 128 + \
                    3 * (blockIdx.y * gridDim.x + blockIdx.x);                   \
    unsigned long long t_;                                                       \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                       \
    o_[i] = (long long)t_;                                                       \
    if (i == 0) {                                                                \
      unsigned sm_;                                                              \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                           \
      o_[2] = sm_;                                                               \
    }                                                                            \
  } while (0)
#else
#define K10_STAMP(slot) \
  do {                  \
  } while (0)
#define K10_SPAN(i) \
  do {              \
  } while (0)
#endif

struct Mlp1Args {
  const void* x;  // (M, K) tokens: the LN's input and the residual
  const float *g, *b;                        // (K,) LN scale and bias
  const float *w1scale, *b1, *w2scale, *b2;  // (H,), (H,), (K,), (K,)
  const float *s1, *s2;                      // (1,) static scales, on the device
  void* out;                                 // (M, K) in the tokens' dtype
  int M, K, H;
};

// Byte offsets of a CTA's dynamic shared memory, from a 1024-byte aligned
// base: X (kb blocks), the two chunk buffers (ykb blocks each; before the
// chunks, a scratch row per warp and the LN's scale and bias), the w1 ring,
// the w2 ring, then 17 mbarriers.
struct Mlp1Layout {
  int kb, hc, ykb;
  int y, r1, r2, bars, bytes;
};

__host__ __device__ __forceinline__ Mlp1Layout mlp1_layout(int K, int cluster) {
  Mlp1Layout L;
  L.kb = (K + 127) / 128;
  L.hc = M1_FW * cluster;
  L.ykb = (L.hc + 127) / 128;
  L.y = L.kb * M1_TILE;
  L.r1 = L.y + 2 * L.ykb * M1_TILE;
  L.r2 = L.r1 + M1_S1 * M1_TILE;
  L.bars = L.r2 + M1_S2 * M1_W2_STAGE;
  L.bytes = L.bars + 8 * (2 * M1_S1 + 2 * M1_S2 + 5) + 1024;  // + room to align
  return L;
}

// d (64 x 64 s32) += A (64 x 32 s8) . B (64 x 32 s8)^T, both from shared
// memory, K-major.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 160 s32) += A (64 x 32 s8) . B (160 x 32 s8)^T, both from shared
// memory, K-major.
__device__ __forceinline__ void wgmma_s8_n160(int (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

// The byte (row r, column c) of a 64-row operand of 128-byte swizzled blocks.
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return (c >> 7) * M1_TILE + r * 128 + ((((c & 127) >> 4) ^ (r & 7)) << 4) + (c & 15);
}

// The kernel: grid (C, ceil(M / 64)), one cluster of C CTAs per 64 rows.
// Threads: warpgroups 0 and 2 run fc1 (0 the even chunks into buffer 0, 2
// the odd ones into buffer 1, so one's GELU and exchange overlap the other's
// products), warpgroup 1 fc2, warps 12 and 13 the producers.
template <typename TokT, bool POLY>
__global__ void __launch_bounds__(M1_THREADS, 1)
    mlp_block1_kernel(const __grid_constant__ CUtensorMap w1map,
                      const __grid_constant__ CUtensorMap w2map, const Mlp1Args p) {
  extern __shared__ __align__(16) uint8_t m1_smem_raw[];
  uint8_t* smem = m1_smem_raw + ((1024 - (smem_u32(m1_smem_raw) & 1023)) & 1023);
  const int C = gridDim.x;  // the grid's x is one cluster
  const int rank = (int)cluster_ctarank();
  const Mlp1Layout L = mlp1_layout(p.K, C);
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty1 = full1 + M1_S1;
  uint64_t* full2 = empty1 + M1_S1;
  uint64_t* empty2 = full2 + M1_S2;
  uint64_t* yfull = empty2 + M1_S2;  // [2]: every CTA's slice of the chunk has arrived
  uint64_t* yempty = yfull + 2;      // [2]: every CTA's fc2 is done with the buffer
  // the fc1 warpgroup of chunk c has passed its last wait on the w1 ring
  // (phase c): the other one starts chunk c + 1 only then, so that neither
  // waits on a ring stage more than one use ahead of its phase
  uint64_t* turn = yempty + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * M1_BM;
  const int nchunks = (p.H + L.hc - 1) / L.hc;
  const TokT* x = reinterpret_cast<const TokT*>(p.x);
  if (tid == 0) K10_STAMP(0);
  if (tid == 0) K10_SPAN(0);

  // LN + quantize by s1 of the 64 rows into X: the cluster's CTAs share the
  // rows (rank, rank + C, ...), a row per warp at a time through a scratch
  // row in the chunk buffers' space, zeros past K and M, and each row goes
  // to X of every CTA of the cluster.
  {
    int8_t* row = reinterpret_cast<int8_t*>(smem + L.y + warp * L.kb * 128);
    float* gs = reinterpret_cast<float*>(smem + L.y + (M1_THREADS / 32) * L.kb * 128);
    float* bs = gs + p.K;
    const int r0 = rank + C * warp;  // this warp's first row, loaded while g and b stage
    float v[M1_MAX_K / 32];
    if (r0 < M1_BM && m0 + r0 < p.M) load_row(v, x + (size_t)(m0 + r0) * p.K, p.K, lane);
    for (int k = tid; k < p.K; k += M1_THREADS) {
      gs[k] = p.g[k];
      bs[k] = p.b[k];
    }
    __syncthreads();
    for (int r = r0; r < M1_BM; r += C * (M1_THREADS / 32)) {
      const int m = m0 + r;
      if (r != r0 && m < p.M) load_row(v, x + (size_t)m * p.K, p.K, lane);
      if (m < p.M && HYT_K10_DIAG != 4)
        quantize_row_ln_regs(v, gs, bs, p.K, *p.s1, row, lane);
      for (int k = (m < p.M ? p.K : 0) + lane; k < L.kb * 128; k += 32) row[k] = 0;
      __syncwarp();
      for (int v = lane; v < L.kb * 8; v += 32) {
        const uint4 val = *reinterpret_cast<const uint4*>(row + v * 16);
        const uint32_t dst = smem_u32(smem + sw128_offset(r, v * 16));
        for (int pr = 0; pr < C; ++pr) st_cluster_v4(mapa(dst, pr), val);
      }
      __syncwarp();
    }
  }
  fence_proxy_async_cluster();  // X, written generically, before the CTAs' wgmma read it
  __syncthreads();
  if (tid == 0) K10_STAMP(1);
  // The chunk buffers start as zeros: the bytes of a 128-byte block past the
  // chunk (C odd) stay 0 and meet the next chunk's w2 columns.
  for (int i = tid * 16; i < 2 * L.ykb * M1_TILE; i += M1_THREADS * 16)
    *reinterpret_cast<uint4*>(smem + L.y + i) = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < M1_S1; ++s) {
      mbar_init(smem_u32(full1 + s), 1);
      mbar_init(smem_u32(empty1 + s), 1);
    }
    for (int s = 0; s < M1_S2; ++s) {
      mbar_init(smem_u32(full2 + s), 1);
      mbar_init(smem_u32(empty2 + s), 1);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(yfull + b), 1);   // this CTA's fc1, and the others' bytes
      mbar_init(smem_u32(yempty + b), C);  // one fc2 thread of every CTA
    }
    mbar_init(smem_u32(turn), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the zeros, too
  cluster_arrive();     // X is whole and every CTA's barriers exist
  cluster_wait();
  fence_proxy_async();
  if (tid == 0) K10_STAMP(2);

  if (warp == 12) {  // the w1 producer: fc1's 64 columns of each chunk, K in 128-byte steps
    if (lane == 0) {
      int it = 0;
      for (int c = 0; c < nchunks; ++c)
        for (int kb = 0; kb < L.kb; ++kb, ++it) {
          const int s = it % M1_S1;
          mbar_wait(smem_u32(empty1 + s), ((it / M1_S1) & 1) ^ 1);
          const uint32_t bar = smem_u32(full1 + s);
          mbar_arrive_expect_tx(bar, HYT_K10_DIAG == 2 ? 0 : M1_TILE);
          if (HYT_K10_DIAG != 2)
            tma_load(smem_u32(smem + L.r1 + s * M1_TILE), &w1map, kb * 128,
                     c * L.hc + rank * M1_FW, bar);
        }
    }
  } else if (warp == 13) {  // the w2 producer: fc2's 160 (192) columns, the chunk in 128-byte steps
    if (lane == 0) {
      int it = 0;
      for (int c = 0; c < nchunks; ++c)
        for (int kk = 0; kk < L.ykb; ++kk, ++it) {
          const int s = it % M1_S2;
          mbar_wait(smem_u32(empty2 + s), ((it / M1_S2) & 1) ^ 1);
          const uint32_t bar = smem_u32(full2 + s);
          mbar_arrive_expect_tx(bar, HYT_K10_DIAG == 2 ? 0 : M1_W2_STAGE);
          if (HYT_K10_DIAG == 2) continue;
          const uint32_t dst = smem_u32(smem + L.r2 + s * M1_W2_STAGE);
#pragma unroll
          for (int j = 0; j < 3; ++j)
            tma_load(dst + j * M1_TILE, &w2map, c * L.hc + kk * 128, rank * M1_NC + 64 * j, bar);
        }
    }
  } else if (tid < 128 || tid >= 256) {  // fc1, the GELU and the exchange of the slices
    const int b = tid >= 256, t = tid & 127, w = t >> 5, g = lane >> 2, q = lane & 3;
    const int bar_id = b ? 3 : 1;
    const float s1 = *p.s1, inv2 = __fdiv_rn(1.0f, *p.s2);
    const int cb = rank * M1_FW;  // the slice's first byte in the chunk
    uint8_t* ybuf = smem + L.y + b * L.ykb * M1_TILE;
    for (int c = b; c < nchunks; c += 2) {
      // this thread's columns' scales and biases, loaded while the products run
      const int h0 = c * L.hc + cb;
      float ws[8][2], bs[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = h0 + j * 8 + q * 2 + e;
          ws[j][e] = h < p.H ? p.w1scale[h] : 0.0f;
          bs[j][e] = h < p.H ? p.b1[h] : 0.0f;
        }
      int acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0;
      int it = c * L.kb;  // the chunk's first use of the w1 ring
      if (c > 0) mbar_wait(smem_u32(turn), (c - 1) & 1);
      for (int kb = 0; kb < L.kb; ++kb, ++it) {
        const int s = it % M1_S1;
        mbar_wait(smem_u32(full1 + s), (it / M1_S1) & 1);
        if (kb == L.kb - 1 && t == 0) mbar_arrive(smem_u32(turn));
        const uint64_t da = sw128_desc(smem_u32(smem + kb * M1_TILE));
        const uint64_t db = sw128_desc(smem_u32(smem + L.r1 + s * M1_TILE));
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (HYT_K10_DIAG != 6) wgmma_s8_n64(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
        if (kb > 0 && t == 0) mbar_arrive(smem_u32(empty1 + (it - 1) % M1_S1));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(smem_u32(empty1 + (it - 1) % M1_S1));
      if (t == 0) K10_STAMP(3 + 4 * c);

      mbar_wait_cluster(smem_u32(yempty + b), ((c >> 1) & 1) ^ 1);
      if (t == 0) K10_STAMP(4 + 4 * c);
      // branch-free: columns past H (zero scales and biases) are computed,
      // then written as 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + q * 2;
        const bool in_h = h0 + col < p.H;  // H is a multiple of 16: both columns or neither
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = w * 16 + hh * 8 + g;
          uint32_t v = 0;
          if (HYT_K10_DIAG != 1) {
            const int8_t y0 =
                dequant_gelu_q(acc[j * 4 + hh * 2], s1, ws[j][0], bs[j][0], POLY, inv2);
            const int8_t y1 =
                dequant_gelu_q(acc[j * 4 + hh * 2 + 1], s1, ws[j][1], bs[j][1], POLY, inv2);
            v = in_h ? (uint32_t)(uint8_t)y0 | ((uint32_t)(uint8_t)y1 << 8) : 0u;
          }
          *reinterpret_cast<uint16_t*>(ybuf + sw128_offset(r, cb + col)) = (uint16_t)v;
        }
      }
      fence_proxy_async();         // the slice, before this CTA's fc2 reads it
      named_barrier(bar_id, 128);  // the slice is whole in this CTA's buffer
      if (t == 0) K10_STAMP(5 + 4 * c);
      // this CTA's arrival: the other CTAs' slices are the phase's bytes
      if (t == 0)
        mbar_arrive_expect_tx(smem_u32(yfull + b), HYT_K10_DIAG == 3 ? 0 : (C - 1) * M1_SLICE);
      if (HYT_K10_DIAG != 3) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // 64 rows x 4 vectors of 16 bytes, 2 a thread
          const int v = t + 128 * i;
          const int off = sw128_offset(v >> 2, cb + (v & 3) * 16);
          const uint4 val = *reinterpret_cast<const uint4*>(ybuf + off);
          const uint32_t dst = smem_u32(ybuf + off), bar = smem_u32(yfull + b);
          for (int pr = 0; pr < C; ++pr)
            if (pr != rank) st_async_v4(mapa(dst, pr), val, mapa(bar, pr));
        }
      }
      if (t == 0) K10_STAMP(6 + 4 * c);
    }
  } else {  // fc2 over each chunk, then the dequant and the residual
    const int t = tid - 128, w = t >> 5, g = lane >> 2, q = lane & 3;
    int acc[80];
#pragma unroll
    for (int i = 0; i < 80; ++i) acc[i] = 0;
    int it = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int b = c & 1;
      const uint8_t* ybuf = smem + L.y + b * L.ykb * M1_TILE;
      mbar_wait_cluster(smem_u32(yfull + b), (c >> 1) & 1);
      fence_proxy_async();
      if (t == 0) K10_STAMP(64 + 3 * c);
      for (int kk = 0; kk < L.ykb; ++kk, ++it) {
        const int s = it % M1_S2;
        mbar_wait(smem_u32(full2 + s), (it / M1_S2) & 1);
        const uint64_t da = sw128_desc(smem_u32(ybuf + kk * M1_TILE));
        const uint64_t db = sw128_desc(smem_u32(smem + L.r2 + s * M1_W2_STAGE));
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (HYT_K10_DIAG != 7) wgmma_s8_n160(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
        if (kk > 0 && t == 0) mbar_arrive(smem_u32(empty2 + (it - 1) % M1_S2));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(smem_u32(empty2 + (it - 1) % M1_S2));
      if (t == 0) K10_STAMP(65 + 3 * c);
      named_barrier(2, 128);  // every warp's products on the buffer are done
      if (t < C) mbar_arrive_cluster(mapa(smem_u32(yempty + b), t));
    }
    if (t == 0) K10_STAMP(126);
    // dequant + bias, then the residual added in f32 (K4's EPI_RESID),
    // through shared memory (the rings, which every load has left now): the
    // residual tile comes in and the output tile goes out as coalesced
    // 16-byte vectors, where each thread's own elements are 4 or 8 bytes
    // scattered over 16 rows
    if (HYT_K10_DIAG != 1 && HYT_K10_DIAG != 8) {
      constexpr int OP = M1_NC + 8;          // the tile's pitch in elements
      constexpr int VE = 16 / sizeof(TokT);  // elements a vector
      constexpr int NV = M1_BM * M1_NC / VE / 128;  // vectors a thread, at most: 10 or 20
      TokT* tile = reinterpret_cast<TokT*>(smem + L.r1);
      float* wsb = reinterpret_cast<float*>(smem + L.r1 + M1_BM * OP * sizeof(TokT));
      const int c0 = rank * M1_NC, ncols = min(M1_NC, p.K - c0);  // a multiple of 16
      const int vpr = ncols / VE;
      TokT* out = reinterpret_cast<TokT*>(p.out);
      // loads in flight a thread at once: 10 (bf16, all) or 5 (f32), 40 or 20
      // registers beside fc2's 80 accumulators
      constexpr int NB = 20 / (int)sizeof(TokT);
#pragma unroll
      for (int i0 = 0; i0 < NV; i0 += NB) {
        uint4 in[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int v = t + 128 * (i0 + i), r = v / vpr, e = (v % vpr) * VE;
          if (v < M1_BM * vpr && m0 + r < p.M)
            in[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * p.K + c0 + e);
        }
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int v = t + 128 * (i0 + i), r = v / vpr, e = (v % vpr) * VE;
          if (v < M1_BM * vpr && m0 + r < p.M)
            *reinterpret_cast<uint4*>(tile + r * OP + e) = in[i];
        }
      }
      for (int c = t; c < ncols; c += 128) {
        wsb[c] = p.w2scale[c0 + c];
        wsb[M1_NC + c] = p.b2[c0 + c];
      }
      named_barrier(2, 128);
      if (t == 0) K10_STAMP(124);
      const float s2 = *p.s2;
#pragma unroll
      for (int j = 0; j < M1_NC / 8; ++j) {
        const int col = j * 8 + q * 2;  // ncols is a multiple of 16: both or neither
        if (col >= ncols) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          TokT* e = tile + (w * 16 + hh * 8 + g) * OP + col;
          const float z0 = dequant_fold(acc[j * 4 + hh * 2], s2, wsb[col], wsb[M1_NC + col]);
          const float z1 =
              dequant_fold(acc[j * 4 + hh * 2 + 1], s2, wsb[col + 1], wsb[M1_NC + col + 1]);
          e[0] = from_f32<TokT>(__fadd_rn(to_f32(e[0]), z0));
          e[1] = from_f32<TokT>(__fadd_rn(to_f32(e[1]), z1));
        }
      }
      named_barrier(2, 128);
      if (t == 0) K10_STAMP(125);
      for (int v = t; v < M1_BM * vpr; v += 128) {
        const int r = v / vpr, e = (v % vpr) * VE;
        if (m0 + r < p.M)
          *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * p.K + c0 + e) =
              *reinterpret_cast<const uint4*>(tile + r * OP + e);
      }
    }
  }
  __syncwarp();
  if (tid == 128) K10_STAMP(127);
  cluster_arrive();  // no CTA leaves while another may still write to it
  cluster_wait();
  if (tid == 0) K10_SPAN(1);
}

template <typename TokT, bool POLY>
int launch_mlp1(const CUtensorMap& w1map, const CUtensorMap& w2map, const Mlp1Args& p,
                int cluster, cudaStream_t st) {
  auto kernel = mlp_block1_kernel<TokT, POLY>;
  static bool smem_set[MAX_DEVICES] = {};  // the shared-memory limit raised on the device
  int dev = 0, sms = 0;
  if (const int rc = current_sms(&dev, &sms)) return rc;
  const Mlp1Layout L = mlp1_layout(p.K, cluster);
  if (!smem_set[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mlp1_layout(M1_MAX_K, M1_MAX_CLUSTER).bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.M + M1_BM - 1) / M1_BM, 1);
  cfg.blockDim = dim3(M1_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, w1map, w2map, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename TokT>
int dispatch_mlp1(const CUtensorMap& w1map, const CUtensorMap& w2map, const Mlp1Args& p,
                  int gelu_poly, int cluster, cudaStream_t st) {
  return gelu_poly ? launch_mlp1<TokT, true>(w1map, w2map, p, cluster, st)
                   : launch_mlp1<TokT, false>(w1map, w2map, p, cluster, st);
}

}  // namespace

// x_f32: the rows are f32 (else bf16). prologue: 0 id, 1 ln (g, b: (K,) f32),
// 2 exact GELU, 3 polynomial GELU. dynamic: per-row absmax scales written to
// row_scale (M,), else the static scale at s, a (1,) f32 on the device.
// chain: K5's chain form (quantize_row's CHAIN). xq: (M, K) int8.
extern "C" int hyt_quantize_rows(const void* x, int x_f32, const void* g, const void* b,
                                 int prologue, int M, int K, int dynamic, const void* s,
                                 int chain, void* xq, void* row_scale, void* stream) {
  if (M <= 0 || K <= 0 || prologue < 0 || prologue > 3) return (int)cudaErrorInvalidValue;
  if (prologue == PRO_LN && (!g || !b)) return (int)cudaErrorInvalidValue;
  if (dynamic ? !row_scale : !s) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *gf = (const float*)g, *bf = (const float*)b, *sf = (const float*)s;
  int8_t* q = (int8_t*)xq;
  float* rs = (float*)row_scale;
  if (chain)
    return x_f32 ? dispatch_quantize<float, true>(x, gf, bf, prologue, M, K, dynamic, sf, q, rs, st)
                 : dispatch_quantize<bf16, true>(x, gf, bf, prologue, M, K, dynamic, sf, q, rs, st);
  return x_f32 ? dispatch_quantize<float, false>(x, gf, bf, prologue, M, K, dynamic, sf, q, rs, st)
               : dispatch_quantize<bf16, false>(x, gf, bf, prologue, M, K, dynamic, sf, q, rs, st);
}

// The TMA map of a K-major (N, K) int8 weight at wt, written to map (128
// bytes of host memory): the wrapper makes it once per weight, beside the
// weight's K-major copy, and hands it to every hyt_int8_gemm on that weight.
// K % 16 == 0, N % 16 == 0, wt 16-byte aligned.
extern "C" int hyt_weight_map(const void* wt, int N, int K, void* map) {
  if (N <= 0 || K <= 0 || K % 16 || N % 16 || (reinterpret_cast<uintptr_t>(wt) & 15) || !map)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const int rc = encode_kmajor(&m, wt, N, K);
  if (rc == 0) memcpy(map, &m, sizeof m);
  return rc;
}

// out = epilogue(a (M, K) int8 @ w^T), w the K-major (N, K) int8 weight whose
// map hyt_weight_map wrote to wmap. epi: the Epilogue above. out_kind: 0
// bf16, 1 f32, 2 int8 (EPI_GELU_Q only); res has the output's dtype.
// row_scale (M,) or, where it is null, s: (1,) f32 scales on the device, as
// out_scale; wscale and bias (N,) f32. K % 16 == 0 and N % 16 == 0; a, out,
// res, wscale and bias 16-byte aligned.
extern "C" int hyt_int8_gemm(const void* a, const void* wmap, int M, int N, int K, int epi,
                             int out_kind, const void* row_scale, const void* s,
                             const void* wscale, const void* bias, const void* res,
                             const void* out_scale, int gelu_poly, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16 || !wmap || !wscale || !bias)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(wscale) |
       reinterpret_cast<uintptr_t>(bias)) & 15)
    return (int)cudaErrorInvalidValue;
  if ((epi == EPI_RESID || epi == EPI_PROJ) && !res) return (int)cudaErrorInvalidValue;
  if ((epi == EPI_GELU_Q) != (out_kind == 2) || (epi == EPI_GELU_Q && !out_scale))
    return (int)cudaErrorInvalidValue;
  if (!row_scale && !s) return (int)cudaErrorInvalidValue;
  // A's map is encoded from its address on every call and passed by value:
  // a CUDA graph that captures this launch (pipeline/captured.py) keeps the
  // map of the capture, which is right only because a replay reads A at the
  // same address, the graph's static buffer.
  CUtensorMap amap, wm;
  const int rc = encode_kmajor(&amap, a, M, K);
  if (rc) return rc;
  memcpy(&wm, wmap, sizeof wm);
  GemmArgs p;
  p.row_scale = (const float*)row_scale;
  p.wscale = (const float*)wscale;
  p.bias = (const float*)bias;
  p.res = res;
  p.out = out;
  p.s = (const float*)s;
  p.out_scale = (const float*)out_scale;
  p.gelu_poly = gelu_poly;
  p.M = M;
  p.N = N;
  p.K = K;
  return dispatch_gemm(epi, out_kind, amap, wm, p, (cudaStream_t)stream);
}

// K10: out (M, K) = x + fc2(GELU(fc1(LN(x)))) in one launch. x (M, K) f32
// with x_f32, else bf16; out has its dtype. g, b (K,); w1map and w2map the
// TMA maps (hyt_weight_map) of the K-major copies of w1 (K, H), as (H, K),
// and of w2 (H, K), as (K, H); w1scale, b1 (H,), w2scale, b2 (K,), all f32;
// s1, s2: (1,) f32 static scales on the device. K % 16 == 0, H % 16 == 0,
// K <= 1280; cluster: the CTAs of a cluster, ceil(K / 160).
extern "C" int hyt_mlp_block1(const void* x, int x_f32, const void* g, const void* b,
                              const void* w1map, const void* w1scale, const void* b1,
                              const void* w2map, const void* w2scale, const void* b2,
                              const void* s1, const void* s2, int gelu_poly, int M, int K, int H,
                              int cluster, void* out, void* stream) {
  if (M <= 0 || K <= 0 || H <= 0 || K % 16 || H % 16 || K > M1_MAX_K || !s1 || !s2 || !g ||
      !b || !w1map || !w2map || !w1scale || !b1 || !w2scale || !b2)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > M1_MAX_CLUSTER || cluster * M1_NC < K ||
      (cluster - 1) * M1_NC >= K || M > 65535 * M1_BM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m1, m2;
  memcpy(&m1, w1map, sizeof m1);
  memcpy(&m2, w2map, sizeof m2);
  Mlp1Args p;
  p.x = x;
  p.g = (const float*)g;
  p.b = (const float*)b;
  p.w1scale = (const float*)w1scale;
  p.b1 = (const float*)b1;
  p.w2scale = (const float*)w2scale;
  p.b2 = (const float*)b2;
  p.s1 = (const float*)s1;
  p.s2 = (const float*)s2;
  p.out = out;
  p.M = M;
  p.K = K;
  p.H = H;
  cudaStream_t st = (cudaStream_t)stream;
  return x_f32 ? dispatch_mlp1<float>(m1, m2, p, gelu_poly, cluster, st)
               : dispatch_mlp1<bf16>(m1, m2, p, gelu_poly, cluster, st);
}
