// K3's opt-in attention forms: the exp2 / exp2p softmax flavours and the
// int8 attention products, each with an int8 output quantized by 1 / sx_proj.
//
// Replaces the branches of the TPU kernel
// hamer_yolo_tpu/ops/attention_pallas.py:fused_int8_attn_proj_block
// (_attn_proj_block_kernel) that JAX's switches turn on:
//  - HYT_SOFTMAX=exp2: log2(e) folded into the q prescale (qs = scale *
//    LOG2E, rounded to bf16 with q), exp2 of the max-shifted logits;
//    HYT_SOFTMAX=exp2p: besides, e unnormalised into the P V product and the
//    row's 1 / sum applied with 1 / sx_proj in the epilogue. These are the
//    bf16 kernels of short_attention.cu (their device code is in
//    short_attention.cuh) built with the flavour template parameter, for an
//    int8 output only: K3 is their one caller. Built in a file of their own so that nvcc compiles
//    them beside short_attention.cu, not after it.
//  - HYT_ATTN_MATH=int8 (attention_int8_kernel below): per (crop, head) the
//    three f32 tile scales s = max |t| * f32(1 / 127) + 1e-12 over the
//    whole (N, hd) head of q, k and v; t quantized as rint(t * (1 / s)) with
//    no clip; logits = f32(qi . ki^T) * (qs * (sq * sk)) (qs = scale, or
//    scale * LOG2E under exp2, in f32); the softmax (exp or exp2); p
//    quantized as rint((e * (1 / sum)) * 127); res = f32(pi . vi) *
//    ((sv * f32(1 / 127)) * (1 / sx_proj)); the output clip(rint(res), +-127).
//    JAX's f32 operation order, each step with the _rn intrinsics (the plain
//    version: ops/short_attention.flavoured_attention_ref).
//
// What bounds the int8 products on the H100: per ViT-H layer (16 crops x 16
// heads, N = 192, hd = 80) the two products are 1.5 G int8 multiply-adds
// against 23.6 MB of bf16 q, k, v read and 3.9 MB of int8 written, so bytes
// bound it (8.2 us at 3.35 TB/s). What the design does about it: each
// (crop, head) is one CTA that reads its head's q, k and v twice (the
// absmax pass, then the quantize pass, the second from L2) and keeps
// everything else in shared memory: the int8 Q, K and a transposed V (8-bit
// mma takes both operands K-major, so V is stored keys-contiguous; hd pads
// to 32 for the k32 depth, N to 32), each warp's 16 x N f32 logits and its
// int8 p. The products are mma.sync.m16n8k32 s8 (exact int32 sums), four
// warps over the 16-row query tiles. A simple kernel: no wgmma, no overlap
// of loads and math; its time is in PERF.md. N is at most MAX_N_I8 (the
// head in shared memory: 176 KB at N = 256, hd = 128).
#include "short_attention.cuh"

namespace {

constexpr int I8W = 4;           // warps of an int8 CTA
constexpr int I8T = I8W * 32;    // its threads
constexpr int MAX_N_I8 = 256;    // keys of a head the int8 kernel holds
constexpr float kRecip127 = 1.0f / 127.0f;

__host__ __device__ __forceinline__ int round32(int x) { return (x + 31) & ~31; }

// Shared memory of the int8 kernel: Q (round16(N) x Hk), K (Nk x Hk), V
// transposed (Hk x Nk), each warp's logits (16 x Nk f32) and p (16 x Nk int8),
// and 3 x I8W floats for the absmax reduction; Nk = round32(N), Hk =
// round32(hd).
__host__ __device__ __forceinline__ int int8_smem_bytes(int N, int hd) {
  const int Nk = round32(N), Hk = round32(hd);
  return round16(N) * Hk + 2 * Nk * Hk + I8W * 16 * Nk * 5 + 3 * I8W * 4;
}

// c (16 x 8 s32) += A (16 x 32 s8, row-major fragments) . B (32 x 8 s8,
// column-major fragments): exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rint(v * inv) as int8, no clip: the tile scale keeps |v * inv| below 127.5.
__device__ __forceinline__ int8_t round_no_clip(float v, float inv) {
  return (int8_t)(int)rintf(__fmul_rn(v, inv));
}

// The A fragments of rows g and g + 8 of a 16-row int8 tile at a (ld bytes a
// row), k = k0 .. k0 + 31.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const int8_t* t, int ld, int k0, int g,
                                       int t4) {
  a[0] = ld32(t + g * ld + k0 + 4 * t4);
  a[1] = ld32(t + (g + 8) * ld + k0 + 4 * t4);
  a[2] = ld32(t + g * ld + k0 + 16 + 4 * t4);
  a[3] = ld32(t + (g + 8) * ld + k0 + 16 + 4 * t4);
}

__device__ __forceinline__ void store_pair(int8_t* out, int c0, int c1, float cv) {
  char2 v;
  v.x = (char)(int)fminf(fmaxf(rintf(__fmul_rn(__int2float_rn(c0), cv)), -127.0f), 127.0f);
  v.y = (char)(int)fminf(fmaxf(rintf(__fmul_rn(__int2float_rn(c1), cv)), -127.0f), 127.0f);
  *reinterpret_cast<char2*>(out) = v;
}

// One CTA per (head, crop): grid (H, B). p.scale is qs in f32.
template <bool EXP2>
__global__ void __launch_bounds__(I8T) attention_int8_kernel(const AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* pq = reinterpret_cast<const bf16*>(p.q);
  const bf16* pk = reinterpret_cast<const bf16*>(p.k);
  const bf16* pv = reinterpret_cast<const bf16*>(p.v);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int N = p.N, hd = p.hd, Nq = round16(N), Nk = round32(N), Hk = round32(hd);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);    // Nq x Hk
  int8_t* Ks = Qs + Nq * Hk;                        // Nk x Hk
  int8_t* Vt = Ks + Nk * Hk;                        // Hk x Nk: V transposed
  float* L = reinterpret_cast<float*>(Vt + Hk * Nk);  // I8W x 16 x Nk
  int8_t* P = reinterpret_cast<int8_t*>(L + I8W * 16 * Nk);  // I8W x 16 x Nk
  float* red = reinterpret_cast<float*>(P + I8W * 16 * Nk);  // 3 x I8W

  // The head's absmax of q, k and v, then their scales.
  const long long base = (long long)b * p.ib + (long long)h * p.ih;
  float mq = 0.0f, mk = 0.0f, mv = 0.0f;
  for (int e = tid; e < N * hd; e += I8T) {
    const int r = e / hd, c = e - r * hd;
    const long long off = base + (long long)r * p.in + c;
    mq = fmaxf(mq, fabsf(__bfloat162float(pq[off])));
    mk = fmaxf(mk, fabsf(__bfloat162float(pk[off])));
    mv = fmaxf(mv, fabsf(__bfloat162float(pv[off])));
  }
  mq = warp_max(mq);
  mk = warp_max(mk);
  mv = warp_max(mv);
  if (lane == 0) {
    red[warp] = mq;
    red[I8W + warp] = mk;
    red[2 * I8W + warp] = mv;
  }
  __syncthreads();
  float sc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float m = red[i * I8W];
#pragma unroll
    for (int w = 1; w < I8W; ++w) m = fmaxf(m, red[i * I8W + w]);
    sc[i] = __fadd_rn(__fmul_rn(m, kRecip127), 1e-12f);
  }
  const float iq = __fdiv_rn(1.0f, sc[0]), ik = __fdiv_rn(1.0f, sc[1]),
              iv = __fdiv_rn(1.0f, sc[2]);

  // The int8 tiles, zeros in the padding; V written transposed.
  for (int e = tid; e < Nk * Hk; e += I8T) {
    const int r = e / Hk, c = e - r * Hk;
    const bool in = r < N && c < hd;
    const long long off = in ? base + (long long)r * p.in + c : 0;
    if (r < Nq) Qs[e] = in ? round_no_clip(__bfloat162float(pq[off]), iq) : 0;
    Ks[e] = in ? round_no_clip(__bfloat162float(pk[off]), ik) : 0;
    Vt[c * Nk + r] = in ? round_no_clip(__bfloat162float(pv[off]), iv) : 0;
  }
  __syncthreads();

  const float cl = __fmul_rn(p.scale, __fmul_rn(sc[0], sc[1]));  // qs * (sq * sk)
  const float cv = __fmul_rn(__fmul_rn(sc[2], kRecip127), __fdiv_rn(1.0f, *p.out_scale));
  float* Lw = L + warp * 16 * Nk;
  int8_t* Pw = P + warp * 16 * Nk;
  int8_t* out = reinterpret_cast<int8_t*>(p.out) + (long long)b * p.ob + (long long)h * p.oh;
  for (int tile = warp; tile < Nq / 16; tile += I8W) {
    const int8_t* qa = Qs + tile * 16 * Hk;
    // logits of the tile's 16 rows, 8 keys at a time
    for (int j = 0; j < Nk / 8; ++j) {
      int c[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < Hk; k0 += 32) {
        uint32_t a[4];
        a_frag(a, qa, Hk, k0, g, t4);
        const int8_t* kb = Ks + (j * 8 + g) * Hk + k0 + 4 * t4;
        mma_s8(c, a, ld32(kb), ld32(kb + 16));
      }
      float* l0 = Lw + g * Nk + j * 8 + 2 * t4;
      float* l1 = l0 + 8 * Nk;
      l0[0] = __fmul_rn(__int2float_rn(c[0]), cl);
      l0[1] = __fmul_rn(__int2float_rn(c[1]), cl);
      l1[0] = __fmul_rn(__int2float_rn(c[2]), cl);
      l1[1] = __fmul_rn(__int2float_rn(c[3]), cl);
    }
    __syncwarp();
    {  // the softmax, two threads a row, and p as int8
      const int r = lane >> 1, part = lane & 1;
      float* lr = Lw + r * Nk;
      float m = -INFINITY;
      for (int k = part; k < N; k += 2) m = fmaxf(m, lr[k]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      float sum = 0.0f;
      for (int k = part; k < N; k += 2) {
        const float x = __fsub_rn(lr[k], m);
        const float e = EXP2 ? exp2f(x) : expf(x);
        lr[k] = e;
        sum = __fadd_rn(sum, e);
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      const float inv_s = __fdiv_rn(1.0f, sum);
      int8_t* pr = Pw + r * Nk;
      for (int k = part; k < Nk; k += 2)
        pr[k] = k < N ? (int8_t)(int)rintf(__fmul_rn(__fmul_rn(lr[k], inv_s), 127.0f)) : 0;
    }
    __syncwarp();
    // res = (pi . vi) * cv, 8 output columns at a time
    const int row0 = tile * 16 + g, row1 = row0 + 8;
    for (int jd = 0; jd * 8 < hd; ++jd) {
      int c[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < Nk; k0 += 32) {
        uint32_t a[4];
        a_frag(a, Pw, Nk, k0, g, t4);
        const int8_t* vb = Vt + (jd * 8 + g) * Nk + k0 + 4 * t4;
        mma_s8(c, a, ld32(vb), ld32(vb + 16));
      }
      const int col = jd * 8 + 2 * t4;
      if (row0 < N) store_pair(out + (long long)row0 * p.on + col, c[0], c[1], cv);
      if (row1 < N) store_pair(out + (long long)row1 * p.on + col, c[2], c[3], cv);
    }
    __syncwarp();
  }
}

// The bf16 kernels of short_attention.cu under flavour FL, int8 output.
template <int FL>
Kernel flavour_kernel(int N, int hd) {
  if (N > MAX_N1) {
    switch (round16(hd) / 16) {
      case 1: return attention_bf16_long_kernel<1, FL>;
      case 2: return attention_bf16_long_kernel<2, FL>;
      case 3: return attention_bf16_long_kernel<3, FL>;
      case 4: return attention_bf16_long_kernel<4, FL>;
      case 5: return attention_bf16_long_kernel<5, FL>;
      case 6: return attention_bf16_long_kernel<6, FL>;
      case 7: return attention_bf16_long_kernel<7, FL>;
      default: return attention_bf16_long_kernel<8, FL>;
    }
  }
  const int nch = (N + 63) / 64;
  return nch == 1   ? attention_bf16_kernel<1, int8_t, FL>
         : nch == 2 ? attention_bf16_kernel<2, int8_t, FL>
         : nch == 3 ? attention_bf16_kernel<3, int8_t, FL>
                    : attention_bf16_kernel<4, int8_t, FL>;
}

AttnArgs args(const void* q, const void* k, const void* v, long long ib, long long ih,
              long long in, void* out, const void* out_scale, long long ob, long long oh,
              long long on, int N, int hd, float scale) {
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
  p.out_kind = 2;
  return p;
}

bool bad_args(const AttnArgs& p, int B, int H) {
  return p.N <= 0 || p.hd <= 0 || p.hd > MAX_HD || B <= 0 || H <= 0 || p.hd % 8 ||
         p.ib % 8 || p.ih % 8 || p.in % 8 || p.ob % 8 || p.oh % 8 || p.on % 8 ||
         (uintptr_t)p.out % 16 || !p.out_scale;
}

}  // namespace

extern "C" int hyt_attention_int8_smem_bytes(int N, int hd) { return int8_smem_bytes(N, hd); }

// K3's attention under HYT_SOFTMAX: q, k, v bf16 (B, H, N, hd) through the
// element strides (ib, ih, in), hd contiguous; out int8 through (ob, oh, on),
// quantized by 1 / *out_scale ((1,) f32 on the device). flavour: 1 exp2, 2
// exp2p; scale: qs rounded to bf16. hd % 8 == 0 and hd <= 128, the strides
// multiples of 8, the pointers 16-byte aligned.
extern "C" int hyt_attention_flavour(const void* q, const void* k, const void* v, long long ib,
                                     long long ih, long long in, void* out,
                                     const void* out_scale, long long ob, long long oh,
                                     long long on, int B, int H, int N, int hd, float scale,
                                     int flavour, void* stream) {
  const AttnArgs p = args(q, k, v, ib, ih, in, out, out_scale, ob, oh, on, N, hd, scale);
  if (bad_args(p, B, H) || (flavour != FL_EXP2 && flavour != FL_EXP2P))
    return (int)cudaErrorInvalidValue;
  const Kernel kernel =
      flavour == FL_EXP2 ? flavour_kernel<FL_EXP2>(N, hd) : flavour_kernel<FL_EXP2P>(N, hd);
  return launch(kernel, CT, TPC * QT, p, 2, B, H, (cudaStream_t)stream);
}

// K3's attention under HYT_ATTN_MATH=int8 (with exp2: HYT_SOFTMAX=exp2 or
// exp2p), the arguments as above; scale: qs in f32. N <= 256.
extern "C" int hyt_attention_int8(const void* q, const void* k, const void* v, long long ib,
                                  long long ih, long long in, void* out, const void* out_scale,
                                  long long ob, long long oh, long long on, int B, int H, int N,
                                  int hd, float scale, int exp2, void* stream) {
  const AttnArgs p = args(q, k, v, ib, ih, in, out, out_scale, ob, oh, on, N, hd, scale);
  if (bad_args(p, B, H) || N > MAX_N_I8) return (int)cudaErrorInvalidValue;
  const Kernel kernel = exp2 ? attention_int8_kernel<true> : attention_int8_kernel<false>;
  const int smem = int8_smem_bytes(N, hd);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), I8T, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
