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
// f32 inputs (the JAX kernels take any float dtype): both products in f32
// on the CUDA cores with explicit FMAs, p left in f32, K and V of the head
// and a 64-row q tile in shared memory (193 KB at N = 192, hd = 80; K rows
// padded by one float so the logits' reads are free of bank conflicts). It
// is the slow and right form of a path the CLI does not take (its tokens are
// bf16).
//
// Design: one CTA per (query tile of 64 rows, head, crop). q, k and v are
// read through (crop, head, row) strides, so a wrapper hands in views of a
// fused (B, N, 3D) qkv tensor (or (B, h, N, hd) tensors) without a
// transpose copy, and the output is written through strides too, into the
// (B, N, h, hd) layout the proj GEMM reads. The head's K and V, the scaled Q
// tile, the f32 logits and the bf16 probabilities live in shared memory
// (142 KB at N = 192, hd = 80; a whole head with its 192 x 192 logits would
// need about 237 KB, more than the 227 KB a block may have, hence the query
// tiles); N and hd are padded to multiples of 16 with zero rows and columns,
// and padded keys are left out of the softmax, so the --tiny ViT (N = 12,
// hd = 16) runs it too. bf16 products on the tensor cores through
// nvcuda::wmma 16x16x16 fragments, f32 accumulation. Elementwise steps use
// the _rn intrinsics, so no FMA contraction changes a rounding that the
// plain version does in two steps.
//
// What bounds it on the H100: per ViT-H layer the two products are ~1 GFLOP
// in bf16 (about 1 us at peak) against ~15 MB of q, k, v and output (about
// 4.5 us at 3.35 TB/s), so it is bound by bytes. The design reads each q, k,
// v element once per query tile (K and V of a head are read by 3 tiles at
// N = 192, mostly from L2) and writes the output once, at 1 byte per
// element with the int8 epilogue. The three phases are barrier-separated
// and loads do not overlap math: pipelining is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int QT = 64, AT = 256;

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// K and V (Np x Hp bf16), the Q tile (QT x Hp bf16), the f32 logits, later
// the f32 output (QT x max(Np, Hp)), the bf16 probabilities (QT x Np).
// With f32 inputs (elem 4): K (N x (hd + 1)), V (N x hd), the Q tile
// (QT x hd) and the logits, later the probabilities (QT x N), all f32.
__host__ __device__ __forceinline__ int smem_bytes(int N, int hd, int elem) {
  if (elem == 4) return (round4(N * (hd + 1)) + N * hd + QT * hd + QT * N) * 4;
  const int Np = round16(N), Hp = round16(hd), Sw = Np > Hp ? Np : Hp;
  return (2 * Np * Hp + QT * Hp) * 2 + QT * Sw * 4 + QT * Np * 2;
}

struct AttnArgs {
  const void *q, *k, *v;   // bf16 or f32
  long long ib, ih, in;  // element strides of q, k and v: crop, head, row
  void* out;
  long long ob, oh, on;  // element strides of the output
  int N, hd;
  float scale;             // hd^-0.5 rounded to the inputs' dtype
  const float* out_scale;  // (1,) scale of the int8 output, on the device
};

// The epilogue: o (f32) rounded to the output type; int8 quantized by inv.
__device__ __forceinline__ void store_out(bf16* out, float o, float) {
  *out = __float2bfloat16_rn(o);
}
__device__ __forceinline__ void store_out(float* out, float o, float) { *out = o; }
__device__ __forceinline__ void store_out(int8_t* out, float o, float inv) {
  *out = quantize(o, inv);
}

template <typename OutT>
__device__ __forceinline__ void attention_bf16(const AttnArgs& p, unsigned char* smem) {
  const bf16* pq = reinterpret_cast<const bf16*>(p.q);
  const bf16* pk = reinterpret_cast<const bf16*>(p.k);
  const bf16* pv = reinterpret_cast<const bf16*>(p.v);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N, hd = p.hd;
  const int Np = round16(N), Hp = round16(hd), Sw = Np > Hp ? Np : Hp;

  bf16* Ks = reinterpret_cast<bf16*>(smem);          // Np x Hp
  bf16* Vs = Ks + Np * Hp;                           // Np x Hp
  bf16* Qs = Vs + Np * Hp;                           // QT x Hp
  float* S = reinterpret_cast<float*>(Qs + QT * Hp);  // QT x Np logits, later QT x Hp output
  bf16* P = reinterpret_cast<bf16*>(S + QT * Sw);     // QT x Np probabilities

  const long long base = (long long)b * p.ib + (long long)h * p.ih;
  const int cpr = Hp / 8;  // 16-byte chunks per padded row (hd % 8 == 0)
  for (int c = tid; c < Np * cpr; c += AT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < N && cc < hd) {
      const long long off = base + (long long)r * p.in + cc;
      kv = *reinterpret_cast<const uint4*>(pk + off);
      vv = *reinterpret_cast<const uint4*>(pv + off);
    }
    *reinterpret_cast<uint4*>(Ks + r * Hp + cc) = kv;
    *reinterpret_cast<uint4*>(Vs + r * Hp + cc) = vv;
  }
  for (int c = tid; c < QT * cpr; c += AT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    const int row = qt * QT + r;
    Pack8 o;
    if (row < N && cc < hd) {
      Pack8 in;
      in.u = *reinterpret_cast<const uint4*>(pq + base + (long long)row * p.in + cc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o.h[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(in.h[i]), p.scale));
    } else {
      o.u = make_uint4(0, 0, 0, 0);
    }
    *reinterpret_cast<uint4*>(Qs + r * Hp + cc) = o.u;
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

  // Row softmax over the N real keys; padded key columns get p = 0.
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

  // O = P . Vs (f32), staged in the logits buffer.
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

  const long long obase = (long long)b * p.ob + (long long)h * p.oh;
  OutT* out = reinterpret_cast<OutT*>(p.out);
  const float inv_out = p.out_scale ? __fdiv_rn(1.0f, *p.out_scale) : 0.0f;
  for (int e = tid; e < QT * hd; e += AT) {
    const int r = e / hd, c = e % hd;
    const int row = qt * QT + r;
    if (row < N) store_out(out + obase + (long long)row * p.on + c, O[r * Hp + c], inv_out);
  }
}

// f32 inputs: one thread per logit and per output element, f32 FMAs.
template <typename OutT>
__device__ __forceinline__ void attention_f32(const AttnArgs& p, unsigned char* smem) {
  const float* pq = reinterpret_cast<const float*>(p.q);
  const float* pk = reinterpret_cast<const float*>(p.k);
  const float* pv = reinterpret_cast<const float*>(p.v);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N, hd = p.hd, ldk = hd + 1;

  float* Ks = reinterpret_cast<float*>(smem);  // N x (hd + 1)
  float* Vs = Ks + round4(N * ldk);            // N x hd, 16-byte aligned
  float* Qs = Vs + N * hd;                     // QT x hd, scaled
  float* S = Qs + QT * hd;                     // QT x N logits, then probabilities

  const long long base = (long long)b * p.ib + (long long)h * p.ih;
  const int cpr = hd / 4;  // 16-byte chunks per row (hd % 8 == 0)
  for (int c = tid; c < N * cpr; c += AT) {
    const int r = c / cpr, cc = (c % cpr) * 4;
    const long long off = base + (long long)r * p.in + cc;
    const float4 kv = *reinterpret_cast<const float4*>(pk + off);
    const float4 vv = *reinterpret_cast<const float4*>(pv + off);
    float* kd = Ks + r * ldk + cc;
    kd[0] = kv.x, kd[1] = kv.y, kd[2] = kv.z, kd[3] = kv.w;
    *reinterpret_cast<float4*>(Vs + r * hd + cc) = vv;
  }
  for (int c = tid; c < QT * cpr; c += AT) {
    const int r = c / cpr, cc = (c % cpr) * 4;
    const int row = qt * QT + r;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < N) {
      const float4 in = *reinterpret_cast<const float4*>(pq + base + (long long)row * p.in + cc);
      o = make_float4(__fmul_rn(in.x, p.scale), __fmul_rn(in.y, p.scale),
                      __fmul_rn(in.z, p.scale), __fmul_rn(in.w, p.scale));
    }
    *reinterpret_cast<float4*>(Qs + r * hd + cc) = o;
  }
  __syncthreads();

  // Logits S = Qs . Ks^T: neighbouring threads take neighbouring keys.
  for (int e = tid; e < QT * N; e += AT) {
    const int r = e / N, c = e % N;
    const float* qr = Qs + r * hd;
    const float* kr = Ks + c * ldk;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
    S[e] = acc;
  }
  __syncthreads();

  // Row softmax; p stays f32 (v's dtype).
  for (int r = warp; r < QT; r += AT / 32) {
    float* srow = S + r * N;
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
    for (int c = lane; c < N; c += 32) srow[c] = __fmul_rn(srow[c], inv);
  }
  __syncthreads();

  // O = P . Vs, each element straight to the output.
  const long long obase = (long long)b * p.ob + (long long)h * p.oh;
  OutT* out = reinterpret_cast<OutT*>(p.out);
  const float inv_out = p.out_scale ? __fdiv_rn(1.0f, *p.out_scale) : 0.0f;
  for (int e = tid; e < QT * hd; e += AT) {
    const int r = e / hd, c = e % hd;
    const int row = qt * QT + r;
    if (row >= N) continue;
    const float* pr = S + r * N;
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc = fmaf(pr[k], Vs[k * hd + c], acc);
    store_out(out + obase + (long long)row * p.on + c, acc, inv_out);
  }
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(AT) short_attention_kernel(const AttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(InT) == 4)
    attention_f32<OutT>(p, smem);
  else
    attention_bf16<OutT>(p, smem);
}

template <typename InT, typename OutT>
int launch(const AttnArgs& p, int B, int H, cudaStream_t st) {
  const int smem = smem_bytes(p.N, p.hd, (int)sizeof(InT));
  cudaError_t err = cudaFuncSetAttribute(short_attention_kernel<InT, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + QT - 1) / QT, H, B);
  short_attention_kernel<InT, OutT><<<grid, AT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// in_f32: q, k, v are f32 (else bf16). out_kind 0 bf16 (bf16 inputs only),
// 1 f32, 2 int8.
int dispatch(const AttnArgs& p, int in_f32, int out_kind, int B, int H, cudaStream_t st) {
  if (p.N <= 0 || p.hd <= 0 || B <= 0 || H <= 0 || p.hd % 8 || p.ib % 8 || p.ih % 8 ||
      p.in % 8 || out_kind < 0 || out_kind > 2 || (out_kind == 2) != (p.out_scale != nullptr) ||
      (in_f32 && out_kind == 0))
    return (int)cudaErrorInvalidValue;
  if (in_f32)
    return out_kind == 2 ? launch<float, int8_t>(p, B, H, st) : launch<float, float>(p, B, H, st);
  if (out_kind == 1) return launch<bf16, float>(p, B, H, st);
  return out_kind == 2 ? launch<bf16, int8_t>(p, B, H, st) : launch<bf16, bf16>(p, B, H, st);
}

}  // namespace

extern "C" int hyt_short_attn_smem_bytes(int N, int hd, int elem) {
  return smem_bytes(N, hd, elem);
}

// K7. q, k, v: bf16, or f32 with in_f32, with the element strides (ib, ih, in)
// over (crop, head, row) and hd contiguous; out, written through (ob, oh,
// on): out_kind 0 bf16, 1 f32, 2 int8 quantized by 1 / *out_scale (a (1,)
// f32 on the device). hd % 8 == 0, the input strides multiples of 8 and the
// pointers 16-byte aligned.
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
