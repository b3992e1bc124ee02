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
//  (a) ln_qkv_kernel: LN statistics per row in the prologue (two passes over
//      the row, as the plain version does), then a 64 x 128 output tile per
//      CTA, K stepped by 32. Each A tile is normalised on its way into shared
//      memory and rounded to bf16 there, so the LN output never reaches device
//      memory. bf16 x bf16 -> f32 on the tensor cores through nvcuda::wmma
//      16x16x16 fragments, 8 warps each holding a 32 x 32 accumulator.
//      Epilogue: f32 + bias -> bf16 qkv (B*N, 3D). Tokens are read as bf16 or
//      f32 (template); the LN is f32 either way.
//  (b) attention_kernel: one CTA per (query tile of 64 rows, head, crop). The
//      head's K and V (192 x 80 bf16, 30 KB each), the Q tile, the 64 x 192
//      f32 logits and the bf16 probabilities live in shared memory (142 KB).
//      A whole head in one CTA would need about 237 KB with its 192 x 192
//      logits, more than the 227 KB a block may have; hence the query tiles.
//      N and the head width are padded to multiples of 16 in shared memory
//      (zero rows and columns); logits of padded key columns are left out of
//      the softmax and their probabilities are 0, so any N works (the tiny
//      config has N = 12).
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
// f32 + bias then bf16; q * scale rounded to bf16 (scale itself is the bf16
// value of hd^-0.5, as JAX's weak-typed bf16 * float gives); logits in f32;
// max-subtracted exp, one reciprocal per row; p rounded to bf16 before p.v;
// output rounded once from f32 to the tokens' dtype. Elementwise steps use the
// _rn intrinsics so no FMA contraction changes a rounding that the plain
// version does in two steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// ---------------------------------------------------------------- (a) LN+QKV
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

// ------------------------------------------------------------ (b) attention
constexpr int QT = 64, AT = 256;

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Shared-memory layout of one CTA: K and V (Np x Hp bf16), the Q tile
// (QT x Hp bf16), the f32 logits, later the f32 output (QT x max(Np, Hp)),
// and the bf16 probabilities (QT x Np). Np, Hp: N and hd rounded up to 16.
__host__ __device__ __forceinline__ int attention_smem_bytes(int N, int hd) {
  const int Np = round16(N), Hp = round16(hd), Sw = Np > Hp ? Np : Hp;
  return (2 * Np * Hp + QT * Hp) * 2 + QT * Sw * 4 + QT * Np * 2;
}

template <typename OutT>
__global__ void __launch_bounds__(AT)
attention_kernel(const bf16* __restrict__ qkv, OutT* __restrict__ out, int N, int H, int hd,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = H * hd, ld = 3 * D;
  const int Np = round16(N), Hp = round16(hd), Sw = Np > Hp ? Np : Hp;

  bf16* Ks = reinterpret_cast<bf16*>(smem);  // Np x Hp
  bf16* Vs = Ks + Np * Hp;                    // Np x Hp
  bf16* Qs = Vs + Np * Hp;                    // QT x Hp
  float* S = reinterpret_cast<float*>(Qs + QT * Hp);  // QT x Np logits, later QT x Hp output
  bf16* P = reinterpret_cast<bf16*>(S + QT * Sw);     // QT x Np probabilities

  // K, V and the scaled Q tile, 16-byte chunks (hd % 8 == 0); the padding
  // rows (>= N) and columns (>= hd) are zeros.
  const bf16* base = qkv + (size_t)b * N * ld;
  const int cpr = Hp / 8;
  for (int c = tid; c < Np * cpr; c += AT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < N && cc < hd) {
      const bf16* src = base + (size_t)r * ld + h * hd + cc;
      kv = *reinterpret_cast<const uint4*>(src + D);
      vv = *reinterpret_cast<const uint4*>(src + 2 * D);
    }
    *reinterpret_cast<uint4*>(Ks + r * Hp + cc) = kv;
    *reinterpret_cast<uint4*>(Vs + r * Hp + cc) = vv;
  }
  for (int c = tid; c < QT * cpr; c += AT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    const int row = qt * QT + r;
    Pack8 v;
    if (row < N && cc < hd) {
      Pack8 in;
      in.u = *reinterpret_cast<const uint4*>(base + (size_t)row * ld + h * hd + cc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v.h[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(in.h[i]), scale));
    } else {
      v.u = make_uint4(0, 0, 0, 0);
    }
    *reinterpret_cast<uint4*>(Qs + r * Hp + cc) = v.u;
  }
  __syncthreads();

  // Logits S = Qs . Ks^T (f32), one 16 x 16 fragment at a time per warp.
  const int nc16 = Np / 16;
  for (int f = warp; f < (QT / 16) * nc16; f += AT / 32) {
    const int fr = f / nc16, fc = f % nc16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < Hp; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(a, Qs + fr * 16 * Hp + k, Hp);
      wmma::load_matrix_sync(kb, Ks + fc * 16 * Hp + k, Hp);
      wmma::mma_sync(acc, a, kb, acc);
    }
    wmma::store_matrix_sync(S + fr * 16 * Np + fc * 16, acc, Np, wmma::mem_row_major);
  }
  __syncthreads();

  // Row softmax over the N real keys: max-subtracted exp, one reciprocal per
  // row, p -> bf16; padded key columns get p = 0.
  for (int r = warp; r < QT; r += AT / 32) {
    float* srow = S + r * Np;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(__fsub_rn(srow[c], m));
      srow[c] = e;
      s = __fadd_rn(s, e);
    }
    const float inv = __fdiv_rn(1.0f, warp_sum(s));
    for (int c = lane; c < Np; c += 32)
      P[r * Np + c] = c < N ? __float2bfloat16_rn(__fmul_rn(srow[c], inv)) : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  // O = P . Vs (f32), staged in the logits buffer (QT x Sw floats).
  float* O = S;
  const int hc16 = Hp / 16;
  for (int f = warp; f < (QT / 16) * hc16; f += AT / 32) {
    const int fr = f / hc16, fc = f % hc16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < Np; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(a, P + fr * 16 * Np + k, Np);
      wmma::load_matrix_sync(vb, Vs + k * Hp + fc * 16, Hp);
      wmma::mma_sync(acc, a, vb, acc);
    }
    wmma::store_matrix_sync(O + fr * 16 * Hp + fc * 16, acc, Hp, wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < QT * hd; e += AT) {
    const int r = e / hd, c = e % hd;
    const int row = qt * QT + r;
    if (row < N) out[((size_t)b * N + row) * D + h * hd + c] = from_f32<OutT>(O[r * Hp + c]);
  }
}

template <typename OutT>
int launch_attention(const void* qkv, void* out, int B, int N, int H, int hd, float scale,
                     cudaStream_t stream) {
  const int smem = attention_smem_bytes(N, hd);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + QT - 1) / QT, H, B);
  attention_kernel<OutT><<<grid, AT, smem, stream>>>((const bf16*)qkv, (OutT*)out, N, H, hd,
                                                     scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hyt_attn_smem_bytes(int N, int hd) { return attention_smem_bytes(N, hd); }

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

// out_f32: write the output as f32 (else bf16).
extern "C" int hyt_attention(const void* qkv, void* out, int out_f32, int B, int N, int H, int hd,
                             float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || hd <= 0 || hd % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? launch_attention<float>(qkv, out, B, N, H, hd, scale, st)
                 : launch_attention<bf16>(qkv, out, B, N, H, hd, scale, st);
}
