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
//      it goes through device memory once (M x K bytes), a known cost that
//      a later version removes by quantizing into the GEMM's A tiles.
//  (b) int8_gemm_kernel: a 128 x 128 output tile per CTA, K stepped by 64.
//      8 warps, each a 64 x 32 tile of mma.sync.m16n8k32 s8 x s8 -> s32
//      fragments (exact int32 sums). A tiles are copied as 16-byte rows.
//      The weight stays in JAX's (K, N) layout in device memory; mma wants
//      B k-contiguous, so each thread loads a 4 x 4 byte block and
//      transposes it with __byte_perm on its way into shared memory. The
//      epilogue dequantizes straight from the accumulator registers.
//
// What bounds it on the H100: the ViT-H GEMMs at M = 3072 rows (16 crops x
// 192 tokens) are 10-40 G int8 ops against 5-30 MB of operands, so the
// tensor cores bound them (1,979 TOP/s int8 peak). This first version has
// no cp.async / TMA pipelining and no wgmma, so it runs far below that; the
// mma.sync tiles, the conflict-free fragment loads (rows of 80 bytes) and
// the 128 x 128 tile that re-reads each weight byte M/128 times from L2 are
// what it does about it now. wgmma with TMA-fed multi-stage tiles is the
// follow-up.
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

#include "common.cuh"

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

// ----------------------------------------------------------- (b) int8 GEMM
constexpr int BM = 128, BN = 128, BK = 64, GT = 256;
constexpr int LDS = BK + 16;  // bytes per shared row: 80, conflict-free fragment loads

struct GemmArgs {
  const int8_t* a;         // (M, K) int8
  const int8_t* w;         // (K, N) int8, JAX's (in, out) layout
  const float* row_scale;  // (M,) per-row scales, or null for the scalar s
  const float* wscale;     // (N,)
  const float* bias;       // (N,)
  const void* res;         // (M, N) residual in the output dtype (EPI_RESID, EPI_PROJ)
  void* out;               // (M, N)
  const float* s;          // (1,) static activation scale, used where row_scale is null
  const float* out_scale;  // (1,) scale of the int8 output (EPI_GELU_Q)
  int gelu_poly;           // EPI_GELU_Q: the polynomial GELU (else exact)
  int M, N, K;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// s: the static scale (or this row's); inv_out: 1 / the int8 output's scale.
template <int EPI, typename OutT>
__device__ __forceinline__ void store_out(const GemmArgs& p, int row, int col, int acc, float s,
                                          float inv_out) {
  const float af = __int2float_rn(acc);
  const size_t i = (size_t)row * p.N + col;
  if constexpr (EPI == EPI_DEQ_ROW) {
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(af, s), p.wscale[col]), p.bias[col]);
    ((OutT*)p.out)[i] = from_f32<OutT>(y);
  } else if constexpr (EPI == EPI_DEQ_FOLD) {
    ((OutT*)p.out)[i] = from_f32<OutT>(dequant_fold(acc, s, p.wscale[col], p.bias[col]));
  } else if constexpr (EPI == EPI_GELU_Q) {
    ((int8_t*)p.out)[i] =
        dequant_gelu_q(acc, s, p.wscale[col], p.bias[col], p.gelu_poly, inv_out);
  } else if constexpr (EPI == EPI_RESID) {
    const float z = dequant_fold(acc, s, p.wscale[col], p.bias[col]);
    ((OutT*)p.out)[i] = from_f32<OutT>(__fadd_rn(to_f32(((const OutT*)p.res)[i]), z));
  } else {  // EPI_PROJ
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(af, s), p.wscale[col]), p.bias[col]);
    const float yt = to_f32(from_f32<OutT>(y));
    ((OutT*)p.out)[i] = from_f32<OutT>(__fadd_rn(to_f32(((const OutT*)p.res)[i]), yt));
  }
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

template <int EPI, typename OutT>
__global__ void __launch_bounds__(GT) int8_gemm_kernel(const GemmArgs p) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // [n][k]: the weight tile transposed
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int M = p.M, N = p.N, K = p.K;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK bytes as 16-byte chunks (K % 16 == 0); zeros past the edges.
    for (int c = tid; c < BM * BK / 16; c += GT) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int row = m0 + r, k = k0 + kc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < M && k < K) v = *reinterpret_cast<const uint4*>(p.a + (size_t)row * K + k);
      *reinterpret_cast<uint4*>(As + r * LDS + kc) = v;
    }
    load_b_tile<BK, BN, GT>(p.w, K, N, k0, n0, Bs, LDS, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* base = As + (wm * 64 + mi * 16 + g) * LDS + kk + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = Bs + (wn * 32 + ni * 8 + g) * LDS + kk + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  const float s_static = p.row_scale ? 0.0f : *p.s;
  float inv_out = 0.0f;
  if constexpr (EPI == EPI_GELU_Q) inv_out = __fdiv_rn(1.0f, *p.out_scale);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
      const float s = p.row_scale ? p.row_scale[row] : s_static;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tig * 2;
        if (col < N) {  // N is even: col + 1 < N too
          store_out<EPI, OutT>(p, row, col, acc[mi][ni][h * 2], s, inv_out);
          store_out<EPI, OutT>(p, row, col + 1, acc[mi][ni][h * 2 + 1], s, inv_out);
        }
      }
    }
}

template <int EPI, typename OutT>
int launch_gemm(const GemmArgs& p, cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  int8_gemm_kernel<EPI, OutT><<<grid, GT, 0, st>>>(p);
  return (int)cudaGetLastError();
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
// w1's column band and w2's row band go through load_b_tile like any weight
// tile. K up to 1280 (NT2 = 20 n8-tiles per warp; smaller K takes NT2 = 1, 2
// or 4).
//
// What bounds it on the H100: the same 80.5 G int8 operations as K4 at
// ViT-H's M = 3072, so the tensor cores. What it costs here: every CTA
// re-reads both weights (13.1 MB at ViT-H), M / 16 = 192 times over, 2.5 GB
// from L2 a launch, where K4's 128-row tiles read them 24 times; loads and
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

// out = epilogue(a (M, K) int8 @ w (K, N) int8). epi: the Epilogue above.
// out_kind: 0 bf16, 1 f32, 2 int8 (EPI_GELU_Q only); res has the output's
// dtype. row_scale (M,) or, where it is null, s: (1,) f32 scales on the
// device, as out_scale. K % 16 == 0 and N % 16 == 0; a 16-byte and w 4-byte
// aligned.
extern "C" int hyt_int8_gemm(const void* a, const void* w, int M, int N, int K, int epi,
                             int out_kind, const void* row_scale, const void* s,
                             const void* wscale, const void* bias, const void* res,
                             const void* out_scale, int gelu_poly, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  if ((epi == EPI_RESID || epi == EPI_PROJ) && !res) return (int)cudaErrorInvalidValue;
  if ((epi == EPI_GELU_Q) != (out_kind == 2) || (epi == EPI_GELU_Q && !out_scale))
    return (int)cudaErrorInvalidValue;
  if (!row_scale && !s) return (int)cudaErrorInvalidValue;
  GemmArgs p;
  p.a = (const int8_t*)a;
  p.w = (const int8_t*)w;
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
  cudaStream_t st = (cudaStream_t)stream;
  const bool f32 = out_kind == 1;
  switch (epi) {
    case EPI_DEQ_ROW:
      return f32 ? launch_gemm<EPI_DEQ_ROW, float>(p, st) : launch_gemm<EPI_DEQ_ROW, bf16>(p, st);
    case EPI_DEQ_FOLD:
      return f32 ? launch_gemm<EPI_DEQ_FOLD, float>(p, st) : launch_gemm<EPI_DEQ_FOLD, bf16>(p, st);
    case EPI_GELU_Q: return launch_gemm<EPI_GELU_Q, int8_t>(p, st);
    case EPI_RESID:
      return f32 ? launch_gemm<EPI_RESID, float>(p, st) : launch_gemm<EPI_RESID, bf16>(p, st);
    case EPI_PROJ:
      return f32 ? launch_gemm<EPI_PROJ, float>(p, st) : launch_gemm<EPI_PROJ, bf16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
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
