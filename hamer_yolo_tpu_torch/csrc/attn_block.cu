// Exact-bf16 fused LN + QKV GEMM + softmax attention block (pre-proj).
//
// Replaces the TPU kernel
// hamer_yolo_tpu/ops/attention_pallas.py:fused_bf16_attn_block
// (_attn_block_bf16_kernel): f32 LayerNorm (eps 1e-6) -> bf16 (M, K) x (K, 3D)
// QKV GEMM with f32 accumulate + f32 bias -> bf16 -> per head
// softmax(bf16(q * scale) k^T) v with f32 accumulate -> (B, N, D) in the
// tokens' dtype (bf16 or f32, as the TPU kernel's out_shape is tok.dtype).
// ViT-H: tokens (B, 192, 1280), w (1280, 3840), 16 heads of width 80.
//
// Two launches in this first version:
//  (a) ln_qkv_kernel, here: LN statistics per row in the prologue (two passes
//      over the row, as the plain version does), then a 64 x 128 output tile
//      per CTA, K stepped by 32. Each A tile is normalised on its way into
//      shared memory and rounded to bf16 there, so the LN output never reaches
//      device memory. bf16 x bf16 -> f32 on the tensor cores through
//      nvcuda::wmma 16x16x16 fragments, 8 warps each holding a 32 x 32
//      accumulator. Epilogue: f32 + bias -> bf16 qkv (B*N, 3D). Tokens are
//      read as bf16 or f32 (template); the LN is f32 either way.
//  (b) the attention of csrc/short_attention.cu (which K3 and K7 launch
//      too) on strided views of the qkv buffer, its output in the tokens'
//      dtype; ops/attn_block.py makes both launches.
//
// What bounds it on the H100: at B*N = 1536 rows the QKV GEMM is 15 GFLOP
// against 16 MB of operands, so it is compute-bound on the tensor cores; the
// attention products are ~1 GFLOP per layer and bound by the qkv round trip
// through device memory (B*N*3D bf16 written by (a), read by (b)). That round
// trip is the known cost of this version: fusing (a) and (b) into one launch
// that keeps qkv on chip, then moving the GEMM to wgmma with TMA-fed tiles,
// is later work. No cp.async pipelining yet either: simple and right first.
//
// Rounding points follow the TPU kernel exactly: LN in f32 then bf16; qkv in
// f32 + bias then bf16 (the attention's own: csrc/short_attention.cu).
// Elementwise steps use the _rn intrinsics so no FMA contraction changes a
// rounding that the plain version does in two steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

// Eight consecutive tokens (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  Pack8 in;
  in.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(in.h[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

constexpr int BM = 64, BN = 128, BK = 32, GT = 256;
constexpr int LDA = BK + 8;  // bf16 elements; row stride 80 B keeps 16 B / 32 B alignment
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 staging of the accumulators
constexpr int kTileBytes = BM * LDA * 2 + BK * LDB * 2;
constexpr int kStageBytes = BM * LDC * 4;
constexpr int kSmemA = kTileBytes > kStageBytes ? kTileBytes : kStageBytes;

template <typename TokT>
__global__ void __launch_bounds__(GT)
ln_qkv_kernel(const TokT* __restrict__ tok, const bf16* __restrict__ w,
              const float* __restrict__ bias, const float* __restrict__ gamma,
              const float* __restrict__ beta, bf16* __restrict__ qkv, int M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[kSmemA];
  __shared__ float s_mu[BM], s_rstd[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Prologue: LN statistics of the tile's rows, one warp per row.
  for (int r = warp; r < BM; r += GT / 32) {
    const int row = m0 + r;
    float mu = 0.0f, rstd = 0.0f;
    if (row < M) {
      const TokT* x = tok + (size_t)row * K;
      float s = 0.0f;
      for (int k = lane; k < K; k += 32) s = __fadd_rn(s, to_f32(x[k]));
      mu = __fdiv_rn(warp_sum(s), (float)K);
      float v = 0.0f;
      for (int k = lane; k < K; k += 32) {
        const float d = __fsub_rn(to_f32(x[k]), mu);
        v = __fadd_rn(v, __fmul_rn(d, d));
      }
      const float var = __fdiv_rn(warp_sum(v), (float)K);
      rstd = rsqrtf(__fadd_rn(var, 1e-6f));
    }
    if (lane == 0) {
      s_mu[r] = mu;
      s_rstd[r] = rstd;
    }
  }
  __syncthreads();

  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32 x 32 each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: 64 x 32 normalised rows, one 8-wide chunk per thread
      const int r = tid >> 2, kc = (tid & 3) * 8;
      const int row = m0 + r, k = k0 + kc;
      Pack8 out;
      if (row < M && k < K) {
        float in[8];
        load8(tok + (size_t)row * K + k, in);
        const float mu = s_mu[r], rstd = s_rstd[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xn = __fmul_rn(__fsub_rn(in[i], mu), rstd);
          out.h[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(xn, gamma[k + i]), beta[k + i]));
        }
      } else {
        out.u = make_uint4(0, 0, 0, 0);
      }
      *reinterpret_cast<uint4*>(As + r * LDA + kc) = out.u;
    }
    for (int c = tid; c < BK * BN / 8; c += GT) {  // B tile: 32 x 128
      const int kr = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int k = k0 + kr, n = n0 + nc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K && n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
      *reinterpret_cast<uint4*>(Bs + kr * LDB + nc) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += GT) {
    const int r = e / BN, c = e % BN;
    const int row = m0 + r, n = n0 + c;
    if (row < M && n < N)
      qkv[(size_t)row * N + n] = __float2bfloat16_rn(__fadd_rn(Cs[r * LDC + c], bias[n]));
  }
}

}  // namespace

// tok_f32: the tokens are f32 (else bf16).
extern "C" int hyt_ln_qkv(const void* tok, int tok_f32, const void* w, const void* bias,
                          const void* gamma, const void* beta, void* qkv, int M, int K, int N,
                          void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (tok_f32)
    ln_qkv_kernel<float><<<grid, GT, 0, st>>>((const float*)tok, (const bf16*)w,
                                              (const float*)bias, (const float*)gamma,
                                              (const float*)beta, (bf16*)qkv, M, K, N);
  else
    ln_qkv_kernel<bf16><<<grid, GT, 0, st>>>((const bf16*)tok, (const bf16*)w,
                                             (const float*)bias, (const float*)gamma,
                                             (const float*)beta, (bf16*)qkv, M, K, N);
  return (int)cudaGetLastError();
}
