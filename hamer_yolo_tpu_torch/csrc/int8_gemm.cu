// W8A8 int8 GEMM core of kernels K3, K4, K5, K6 and K10, with its f32
// prologues and dequantizing epilogues.
//
// Replaces the int8 GEMMs of the TPU kernels
//   hamer_yolo_tpu/ops/int8_matmul.py:fused_int8_matmul (K5; _kernel: an
//     [ln | gelu | gelu_poly | id] prologue in f32, per-row dynamic or static
//     int8 quantize, int8 GEMM, (acc * sx) * sw + b),
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

// One warp quantizes one row xr (K values) into qr: the row's LN statistics
// (two passes), its absmax after the prologue where DYN, then the int8 values.
// Returns the row's scale.
template <typename TokT, int PRO, bool DYN>
__device__ __forceinline__ float quantize_row(const TokT* __restrict__ xr,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b, int K,
                                              const float* __restrict__ s_static,
                                              int8_t* __restrict__ qr, int lane) {
  float mu = 0.0f, rstd = 0.0f;
  if constexpr (PRO == PRO_LN) {
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
      m = fmaxf(m, fabsf(prologue<PRO>(to_f32(xr[k]), mu, rstd, g, b, k)));
    scale = fmaxf(__fmul_rn(warp_max(m), 1.0f / 127.0f), 1e-8f);
  } else {
    scale = *s_static;
  }
  const float inv = __fdiv_rn(1.0f, scale);
  for (int k = lane; k < K; k += 32)
    qr[k] = quantize(prologue<PRO>(to_f32(xr[k]), mu, rstd, g, b, k), inv);
  return scale;
}

template <typename TokT, int PRO, bool DYN>
__global__ void __launch_bounds__(QW * 32)
quantize_rows_kernel(const TokT* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, int M, int K,
                     const float* __restrict__ s_static, int8_t* __restrict__ xq,
                     float* __restrict__ row_scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QW + (threadIdx.x >> 5);
  if (row >= M) return;
  const float scale = quantize_row<TokT, PRO, DYN>(x + (size_t)row * K, g, b, K, s_static,
                                                   xq + (size_t)row * K, lane);
  if (DYN && lane == 0) row_scale[row] = scale;
}

template <typename TokT, int PRO>
int launch_quantize(const void* x, const float* g, const float* b, int M, int K, int dynamic,
                    const float* s, int8_t* xq, float* row_scale, cudaStream_t st) {
  const dim3 grid((M + QW - 1) / QW);
  if (dynamic)
    quantize_rows_kernel<TokT, PRO, true><<<grid, QW * 32, 0, st>>>(
        (const TokT*)x, g, b, M, K, s, xq, row_scale);
  else
    quantize_rows_kernel<TokT, PRO, false><<<grid, QW * 32, 0, st>>>(
        (const TokT*)x, g, b, M, K, s, xq, row_scale);
  return (int)cudaGetLastError();
}

template <typename TokT>
int dispatch_quantize(const void* x, const float* g, const float* b, int prologue, int M, int K,
                      int dynamic, const float* s, int8_t* xq, float* row_scale,
                      cudaStream_t st) {
  switch (prologue) {
    case PRO_ID: return launch_quantize<TokT, PRO_ID>(x, g, b, M, K, dynamic, s, xq, row_scale, st);
    case PRO_LN: return launch_quantize<TokT, PRO_LN>(x, g, b, M, K, dynamic, s, xq, row_scale, st);
    case PRO_GELU:
      return launch_quantize<TokT, PRO_GELU>(x, g, b, M, K, dynamic, s, xq, row_scale, st);
    case PRO_GELU_POLY:
      return launch_quantize<TokT, PRO_GELU_POLY>(x, g, b, M, K, dynamic, s, xq, row_scale, st);
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
  } else {  // EPI_PROJ
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(af, s), sw), b);
    return from_f32<OutT>(__fadd_rn(to_f32(res), to_f32(from_f32<OutT>(y))));
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
  }
  return (int)cudaErrorInvalidValue;
}

// The TMA map of a K-major (rows, K) int8 matrix at base: boxes of 64 rows
// x 128 bytes, the 128-byte swizzle, zeros past the edges.
int encode_kmajor(CUtensorMap* map, const void* base, int rows, int K) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, K, BOX_ROWS, BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// ------------------------------------------------ mma.sync pieces of K10
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A KT x NT byte tile of the (K, N) weight w at (k0, n0), in 4 x 4 blocks
// transposed to Bs[n][k] (rows of lds bytes); zeros past the edges.
template <int KT, int NT, int THREADS>
__device__ __forceinline__ void load_b_tile(const int8_t* __restrict__ w, int K, int N, int k0,
                                            int n0, int8_t* Bs, int lds, int tid) {
  for (int c = tid; c < (KT / 4) * (NT / 4); c += THREADS) {
    const int nb = c % (NT / 4), kb = c / (NT / 4);
    const int n = n0 + nb * 4, k = k0 + kb * 4;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = (n < N && k + i < K) ? *reinterpret_cast<const uint32_t*>(w + (size_t)(k + i) * N + n)
                                  : 0u;
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
    int8_t* dst = Bs + (nb * 4) * lds + kb * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + lds) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * lds) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * lds) = __byte_perm(t2, t3, 0x7632);
  }
}

// ------------------------------------------- K10: the int8 MLP in one launch
// fused_int8_mlp_block1 (_mlp1p_kernel): LN + quantize (s1) + fc1 + GELU +
// quantize (s2) + fc2 + dequant + f32 residual, H taken in chunks with the fc2
// partial sums added in int32, so the result is bit-identical to K4's two
// GEMM launches: the same quantize_row, the same exact int32 sums, the same
// dequant_gelu_q and residual arithmetic.
//
// Design. A CTA owns M1_TM = 16 token rows: one m16 mma tile. Its int8 LN
// output (16 x K) stays in shared memory for the whole kernel. H goes in
// chunks of M1_HC = 128 columns: fc1's 16 x 128 int32 tile (each of the 8
// warps 16 columns) is dequantized, GELU'd and requantized into shared
// memory (the (M, H) int8 tensor that K4 writes to device memory and reads
// back never exists), then multiplied by the chunk's 128 x K row band of w2
// into the CTA's 16 x K int32 accumulator, which lives in registers: each
// warp owns K / 8 output columns, 80 registers a thread at K = 1280. That
// accumulator is why the tile is 16 rows: at 64 rows it is 327 KB, more than
// an SM's registers or shared memory (the TPU keeps it in VMEM at 128 rows).
// w1's column band and w2's row band are read from JAX's (K, N) layout by
// load_b_tile, transposed on their way to shared memory. K up to 1280 (NT2 = 20 n8-tiles per warp; smaller K takes NT2 = 1, 2
// or 4).
//
// What bounds it on the H100: the same 80.5 G int8 operations as K4 at
// ViT-H's M = 3072, so the tensor cores. What it costs here: every CTA
// re-reads both weights (13.1 MB at ViT-H), M / 16 = 192 times over, 2.5 GB
// from L2 a launch, where K4's 128-row GEMM tiles read them 24 times; loads and
// mma do not overlap. It is the simple form that is right; splitting fc2's
// columns over a cluster that shares the GELU chunk through distributed
// shared memory, with taller row tiles, is the follow-up.
constexpr int M1_TM = 16, M1_T = 256, M1_HC = 128, M1_BK1 = 64, M1_BK2 = 32;
constexpr int M1_LDB1 = M1_BK1 + 16, M1_LDY = M1_HC + 16, M1_LDB2 = M1_BK2 + 16;

struct Mlp1Args {
  const void* x;  // (M, K) tokens: the LN's input and the residual
  const float *g, *b;                        // (K,) LN scale and bias
  const int8_t *w1, *w2;                     // (K, H) and (H, K) int8
  const float *w1scale, *b1, *w2scale, *b2;  // (H,), (H,), (K,), (K,)
  const float *s1, *s2;                      // (1,) static scales, on the device
  void* out;                                 // (M, K) in the tokens' dtype
  int gelu_poly;
  int M, K, H;
};

// Bytes of an Xq row: K rounded up to fc1's k step, plus 16 (16 mod 128 at
// K = 1280, so the fragment loads are free of bank conflicts).
__host__ __device__ __forceinline__ int mlp1_ldx(int K) { return ((K + 63) & ~63) + 16; }

__host__ __device__ __forceinline__ int mlp1_smem_bytes(int K, int nt2) {
  return M1_TM * mlp1_ldx(K) + M1_HC * M1_LDB1 + M1_TM * M1_LDY + 64 * nt2 * M1_LDB2;
}

__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const int8_t* base, int ld) {
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * ld + 16);
}

template <typename TokT, int NT2>
__global__ void __launch_bounds__(M1_T) mlp_block1_kernel(const Mlp1Args p) {
  extern __shared__ __align__(16) int8_t m1_smem[];
  const int M = p.M, K = p.K, H = p.H;
  const int ldx = mlp1_ldx(K);
  int8_t* Xq = m1_smem;                 // 16 x ldx: the quantized LN output
  int8_t* Bs1 = Xq + M1_TM * ldx;       // [128 n][64 k]: a tile of w1, transposed
  int8_t* Yq = Bs1 + M1_HC * M1_LDB1;   // 16 x 128: the quantized GELU chunk
  int8_t* Bs2 = Yq + M1_TM * M1_LDY;    // [64 NT2 n][32 k]: a row band of w2, transposed
  const int m0 = blockIdx.x * M1_TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const TokT* x = reinterpret_cast<const TokT*>(p.x);

  for (int r = warp; r < M1_TM; r += M1_T / 32) {
    int8_t* qr = Xq + r * ldx;
    const int row = m0 + r;
    if (row < M)
      quantize_row<TokT, PRO_LN, false>(x + (size_t)row * K, p.g, p.b, K, p.s1, qr, lane);
    for (int k = (row < M ? K : 0) + lane; k < ldx; k += 32) qr[k] = 0;
  }
  __syncthreads();

  const float s1 = *p.s1, s2 = *p.s2;
  const float inv2 = __fdiv_rn(1.0f, s2);
  const int ncol0 = warp * 8 * NT2;  // this warp's first output column
  int acc2[NT2][4];
#pragma unroll
  for (int ni = 0; ni < NT2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc2[ni][r] = 0;

  for (int c0 = 0; c0 < H; c0 += M1_HC) {
    // fc1: Xq (16 x K) @ w1[:, c0 : c0 + 128], each warp 16 columns
    int acc1[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc1[ni][r] = 0;
    for (int k0 = 0; k0 < K; k0 += M1_BK1) {
      load_b_tile<M1_BK1, M1_HC, M1_T>(p.w1, K, H, k0, c0, Bs1, M1_LDB1, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < M1_BK1; kk += 32) {
        uint32_t a[4];
        load_a_frag(a, Xq + g * ldx + k0 + kk + tig * 4, ldx);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int8_t* base = Bs1 + (warp * 16 + ni * 8 + g) * M1_LDB1 + kk + tig * 4;
          mma_s8(acc1[ni], a, *reinterpret_cast<const uint32_t*>(base),
                 *reinterpret_cast<const uint32_t*>(base + 16));
        }
      }
      __syncthreads();
    }
    // dequant -> GELU -> quantize by s2, into Yq; zeros past H
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int cc = warp * 16 + ni * 8 + tig * 2 + (r & 1), col = c0 + cc;
        Yq[(g + (r >> 1) * 8) * M1_LDY + cc] =
            col < H ? dequant_gelu_q(acc1[ni][r], s1, p.w1scale[col], p.b1[col], p.gelu_poly, inv2)
                    : (int8_t)0;
      }
    __syncthreads();
    // fc2: Yq (16 x 128) @ w2[c0 : c0 + 128, :], summed in int32 over the chunks
    for (int kk = 0; kk < M1_HC; kk += M1_BK2) {
      load_b_tile<M1_BK2, 64 * NT2, M1_T>(p.w2, H, K, c0 + kk, 0, Bs2, M1_LDB2, tid);
      __syncthreads();
      uint32_t a[4];
      load_a_frag(a, Yq + g * M1_LDY + kk + tig * 4, M1_LDY);
#pragma unroll
      for (int ni = 0; ni < NT2; ++ni) {
        const int8_t* base = Bs2 + (ncol0 + ni * 8 + g) * M1_LDB2 + tig * 4;
        mma_s8(acc2[ni], a, *reinterpret_cast<const uint32_t*>(base),
               *reinterpret_cast<const uint32_t*>(base + 16));
      }
      __syncthreads();
    }
  }

  // dequant + bias, then the residual added in f32 (K4's EPI_RESID)
  TokT* out = reinterpret_cast<TokT*>(p.out);
#pragma unroll
  for (int ni = 0; ni < NT2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + g + (r >> 1) * 8, col = ncol0 + ni * 8 + tig * 2 + (r & 1);
      if (row < M && col < K) {
        const size_t i = (size_t)row * K + col;
        const float z = dequant_fold(acc2[ni][r], s2, p.w2scale[col], p.b2[col]);
        out[i] = from_f32<TokT>(__fadd_rn(to_f32(x[i]), z));
      }
    }
}

template <typename TokT, int NT2>
int launch_mlp1(const Mlp1Args& p, cudaStream_t st) {
  const int smem = mlp1_smem_bytes(p.K, NT2);
  cudaError_t err = cudaFuncSetAttribute(mlp_block1_kernel<TokT, NT2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_block1_kernel<TokT, NT2><<<(p.M + M1_TM - 1) / M1_TM, M1_T, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename TokT>
int dispatch_mlp1(const Mlp1Args& p, cudaStream_t st) {
  if (p.K <= 64) return launch_mlp1<TokT, 1>(p, st);
  if (p.K <= 128) return launch_mlp1<TokT, 2>(p, st);
  if (p.K <= 256) return launch_mlp1<TokT, 4>(p, st);
  if (p.K <= 1280) return launch_mlp1<TokT, 20>(p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_f32: the rows are f32 (else bf16). prologue: 0 id, 1 ln (g, b: (K,) f32),
// 2 exact GELU, 3 polynomial GELU. dynamic: per-row absmax scales written to
// row_scale (M,), else the static scale at s, a (1,) f32 on the device.
// xq: (M, K) int8.
extern "C" int hyt_quantize_rows(const void* x, int x_f32, const void* g, const void* b,
                                 int prologue, int M, int K, int dynamic, const void* s,
                                 void* xq, void* row_scale, void* stream) {
  if (M <= 0 || K <= 0 || prologue < 0 || prologue > 3) return (int)cudaErrorInvalidValue;
  if (prologue == PRO_LN && (!g || !b)) return (int)cudaErrorInvalidValue;
  if (dynamic ? !row_scale : !s) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return x_f32 ? dispatch_quantize<float>(x, (const float*)g, (const float*)b, prologue, M, K,
                                          dynamic, (const float*)s, (int8_t*)xq,
                                          (float*)row_scale, st)
               : dispatch_quantize<bf16>(x, (const float*)g, (const float*)b, prologue, M, K,
                                         dynamic, (const float*)s, (int8_t*)xq,
                                         (float*)row_scale, st);
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
// with x_f32, else bf16; out has its dtype. g, b (K,), w1 (K, H) int8 with
// w1scale, b1 (H,), w2 (H, K) int8 with w2scale, b2 (K,), all f32; s1, s2:
// (1,) f32 static scales on the device. K % 16 == 0, H % 16 == 0, K <= 1280.
extern "C" int hyt_mlp_block1(const void* x, int x_f32, const void* g, const void* b,
                              const void* w1, const void* w1scale, const void* b1,
                              const void* w2, const void* w2scale, const void* b2,
                              const void* s1, const void* s2, int gelu_poly, int M, int K, int H,
                              void* out, void* stream) {
  if (M <= 0 || K <= 0 || H <= 0 || K % 16 || H % 16 || !s1 || !s2)
    return (int)cudaErrorInvalidValue;
  Mlp1Args p;
  p.x = x;
  p.g = (const float*)g;
  p.b = (const float*)b;
  p.w1 = (const int8_t*)w1;
  p.w2 = (const int8_t*)w2;
  p.w1scale = (const float*)w1scale;
  p.b1 = (const float*)b1;
  p.w2scale = (const float*)w2scale;
  p.b2 = (const float*)b2;
  p.s1 = (const float*)s1;
  p.s2 = (const float*)s2;
  p.out = out;
  p.gelu_poly = gelu_poly;
  p.M = M;
  p.K = K;
  p.H = H;
  cudaStream_t st = (cudaStream_t)stream;
  return x_f32 ? dispatch_mlp1<float>(p, st) : dispatch_mlp1<bf16>(p, st);
}
