// K3's opt-in attention forms: the exp2 / exp2p softmax flavours and the
// int8 attention products, each with an int8 output quantized by 1 / sx_proj.
//
// Replaces the branches of the TPU kernel
// hamer_yolo_tpu/ops/attention_pallas.py:543 fused_int8_attn_proj_block
// (_attn_proj_block_kernel) that JAX's switches turn on:
//  - HYT_SOFTMAX=exp2: log2(e) folded into the q prescale (qs = scale *
//    LOG2E, rounded to bf16 with q), exp2 of the max-shifted logits;
//    HYT_SOFTMAX=exp2p: besides, e unnormalised into the P V product and the
//    row's 1 / sum applied with 1 / sx_proj in the epilogue. These are the
//    bf16 kernels of short_attention.cu (their device code is in
//    short_attention.cuh) built with the flavour template parameter, for an
//    int8 output only: K3 is their one caller. Built in a file of their own so that nvcc compiles
//    them beside short_attention.cu, not after it.
//  - HYT_ATTN_MATH=int8 (the branch at attention_pallas.py:466-506): per
//    (crop, head) the three f32 tile scales s = max |t| * f32(1 / 127) +
//    1e-12 over the whole (N, hd) head of q, k and v; t quantized as
//    rint(t * (1 / s)) with no clip; logits = f32(qi . ki^T) * (qs * (sq *
//    sk)) (qs = scale, or scale * LOG2E under exp2, in f32); the softmax (exp
//    or exp2) over the N keys; p quantized as rint((e * (1 / sum)) * 127);
//    res = f32(pi . vi) * ((sv * f32(1 / 127)) * (1 / sx_proj)); the output
//    clip(rint(res), +-127). JAX's f32 operation order, each step with the
//    _rn intrinsics (the plain versions: ops/short_attention.
//    quantize_heads_ref and int8_products_attention_ref). Any N >= 1.
//
// What bounds the int8 products on the H100: per ViT-H layer (16 crops x 16
// heads, N = 192, hd = 80) the two products are 1.5 G int8 multiply-adds
// (1.5 us at 1,979 TOP/s) against 23.6 MB of bf16 q, k, v read and 3.9 MB of
// int8 written, so bytes bound it (27.5 MB, 8.2 us at 3.35 TB/s). The design
// is two launches:
//  1. quantize_heads_kernel, one CTA per (tensor of q, k, v; head; crop):
//     reads its bf16 head once from the qkv views (16-byte loads, kept in
//     shared memory up to PRE_CACHE bytes; rows past that are read again
//     from L2 for the second step), reduces the absmax, writes the scale to
//     (B, H, 3) and the int8 tile, zero padded: Qi and Ki (Nk x Hk, Hk = hd
//     rounded to 32, the k32 depth of 8-bit wgmma) and V transposed (Hv x
//     Nk, keys contiguous, Hv = hd rounded to 16, the P V product's n: 8-bit
//     wgmma takes both operands K-major), Nk = N rounded to the key block
//     IKB. The tiles are written in the order the attention CTA's shared
//     memory wants (wgmma's core matrices of 8 rows x 16 bytes, unswizzled:
//     blocked_to_plain in ops/short_attention.py undoes it), so every tile
//     the attention reads is one contiguous range: one bulk copy.
//  2. attention_int8_kernel / _long_kernel, one warpgroup per 64 query rows
//     of a (crop, head): 768 CTAs at ViT-H where the old design had 256 of a
//     whole head. The int8 tiles arrive by the TMA unit's bulk copies on
//     mbarriers, from L2 (the pre-pass wrote them just before: 13.3 MB at
//     ViT-H). qi . ki^T and pi . vi run on wgmma m64nNk32 s32.s8.s8 (exact
//     int32 sums; n = 64 for a key block of logits, n = Hv for the output).
//     Up to MAX_NK_SHORT keys the logits of all key blocks stay in the
//     accumulators (64 x 256 int32 at most), so the row max and the sum
//     are taken over the same e values in registers; K's load overlaps
//     nothing but V's lands while S and the softmax run. Beyond, three
//     sweeps over the key blocks, each recomputing qi . ki^T by the same
//     wgmma (the same int32 logits): the exact row max; the sum of e =
//     exp(l - m) with that max; then p, its quantization and P V. K (and in
//     the third sweep V) blocks stream through a ring of STAGES on
//     mbarriers, so the next blocks' copies overlap this block's products.
//     e is computed from the final max in every sweep, as JAX computes it,
//     not rescaled online (an online p would round elsewhere). Pad keys are
//     left out of the max and the sum and get pi = 0. p is quantized in
//     registers and staged once through shared memory as the A operand of P
//     V (the s32 accumulator layout is not the s8 A-fragment layout); the
//     int8 output is staged there too and stored 8 bytes a thread.
//  The bytes this moves at ViT-H: 23.6 MB in, 13.3 MB of tiles out and back
//  (each of a head's three query tiles reads its K and V again, from L2), 3.9
//  MB of output: 54 MB, 16 us at HBM's rate if the tiles left L2.
#include "short_attention.cuh"

namespace {

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

// ------------------------------------------------ the int8 attention products
constexpr int IKB = 64;               // keys of a block; N pads to a multiple of it
constexpr int IT = 128;               // threads of an attention CTA: one warpgroup
constexpr int PRE_T = 256;            // threads of a pre-pass CTA
constexpr int PRE_U = 4;              // its loads in flight a thread
constexpr int PRE_CACHE = 96 * 1024;  // bytes of a bf16 head the pre-pass keeps in shared memory
constexpr int MAX_NK_SHORT = 256;     // keys of the one-block form: four n64 accumulators
constexpr int STAGES = 3;             // key blocks in flight in the three-sweep form
constexpr float kRecip127 = 1.0f / 127.0f;

__host__ __device__ __forceinline__ int round32(int x) { return (x + 31) & ~31; }
__host__ __device__ __forceinline__ int round64(int x) { return (x + 63) & ~63; }

// The padded tile sizes of a head: Nk keys (and query rows), Hk bytes of a
// Qi or Ki row, Hv rows of Vt; bytes of a head's Qi (or Ki) and of its Vt.
struct Tiles {
  int Nk, Hk, Hv;
  long long qk_head, v_head;
};
__host__ __device__ __forceinline__ Tiles tiles_of(int N, int hd) {
  Tiles t;
  t.Nk = round64(N);
  t.Hk = round32(hd);
  t.Hv = round16(hd);
  t.qk_head = (long long)t.Nk * t.Hk;
  t.v_head = (long long)t.Nk * t.Hv;
  return t;
}

struct I8Args {
  const bf16 *q, *k, *v;
  long long ib, ih, in;  // element strides of q, k and v: crop, head, row
  int8_t* tiles;         // Qi of every head, then Ki, then Vt (blocked, see the pre-pass)
  float* scales;         // (B, H, 3): sq, sk, sv
  int8_t* out;
  long long ob, oh, on;  // element strides of the output
  const float* out_scale;
  int B, H, N, hd;
  float qs;  // the q prescale in f32: hd^-0.5, times log2(e) under exp2
  int exp2;
};

// The pre-pass: grid (3, H, B), blockIdx.x picks q, k or v. Qi and Ki are
// written as (Nk / 8) row groups of (Hk / 16) core matrices of 8 rows x 16
// bytes: byte (r, c) at (r / 8) (8 Hk) + (c / 16) 128 + (r % 8) 16 + c % 16.
// Vt as Nk / IKB key blocks of (Hv / 8) row groups of 4 core matrices: byte
// (n, key) at (key / IKB) (IKB Hv) + (n / 8) 512 + (key % IKB / 16) 128 +
// (n % 8) 16 + key % 16. The stores follow that order, contiguous across a
// warp; the first cache_rows rows of the head come from shared memory in the
// second step.
__global__ void __launch_bounds__(PRE_T) quantize_heads_kernel(const I8Args p, int cache_rows) {
  extern __shared__ __align__(16) unsigned char pre_smem[];
  __shared__ float red[PRE_T / 32];
  const int which = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, hd = p.hd, c8 = hd / 8;
  const Tiles T = tiles_of(N, hd);
  const long long bh = (long long)b * p.H + h, BH = (long long)p.B * p.H;
  const bf16* src = (which == 0 ? p.q : which == 1 ? p.k : p.v) + (long long)b * p.ib +
                    (long long)h * p.ih;
  uint4* cache = reinterpret_cast<uint4*>(pre_smem);  // cache_rows x c8 vectors

  // PRE_U loads in flight a thread before their maxima
  float m = 0.0f;
  const int total = N * c8;
  for (int i0 = tid; i0 < total; i0 += PRE_U * PRE_T) {
    Pack8 x[PRE_U];
#pragma unroll
    for (int u = 0; u < PRE_U; ++u) {
      const int i = i0 + u * PRE_T, r = i / c8;
      x[u].u = make_uint4(0, 0, 0, 0);
      if (i < total)
        x[u].u = __ldg(reinterpret_cast<const uint4*>(src + (long long)r * p.in + (i - r * c8) * 8));
    }
#pragma unroll
    for (int u = 0; u < PRE_U; ++u) {
      const int i = i0 + u * PRE_T;
      if (i < total && i / c8 < cache_rows) cache[i] = x[u].u;
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(x[u].h[j])));
    }
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < PRE_T / 32; ++w) m = fmaxf(m, red[w]);
  const float s = __fadd_rn(__fmul_rn(m, kRecip127), 1e-12f);
  const float inv = __fdiv_rn(1.0f, s);
  if (tid == 0) p.scales[bh * 3 + which] = s;

  union Bytes16 {
    uint4 u;
    int8_t b[16];
  };
  if (which < 2) {
    uint4* dst = reinterpret_cast<uint4*>(p.tiles + (which * BH + bh) * T.qk_head);
    const int KC = T.Hk / 16, chunks = (int)(T.qk_head / 16);
    for (int j = tid; j < chunks; j += PRE_T) {
      const int kc = (j >> 3) % KC, r = ((j >> 3) / KC) * 8 + (j & 7);
      Bytes16 o;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = kc * 16 + 8 * half;
        Pack8 x;
        x.u = make_uint4(0, 0, 0, 0);
        if (r < N && c < hd)
          x.u = r < cache_rows ? cache[r * c8 + c / 8]
                               : __ldg(reinterpret_cast<const uint4*>(src + (long long)r * p.in + c));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o.b[8 * half + e] = (int8_t)(int)rintf(__fmul_rn(__bfloat162float(x.h[e]), inv));
      }
      dst[j] = o.u;
    }
  } else {
    // a thread takes 16 keys of 8 columns: 16 row vectors in, the 8 chunks
    // of those columns (128 contiguous bytes) out
    uint4* dst = reinterpret_cast<uint4*>(p.tiles + 2 * BH * T.qk_head + bh * T.v_head);
    const int NR = T.Hv / 8, groups = (int)(T.v_head / 128);
    for (int g = tid; g < groups; g += PRE_T) {
      const int n0 = ((g >> 2) % NR) * 8, key0 = ((g >> 2) / NR) * IKB + (g & 3) * 16;
      Pack8 x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = key0 + e;
        x[e].u = make_uint4(0, 0, 0, 0);
        if (r < N && n0 < hd)
          x[e].u = r < cache_rows
                       ? cache[r * c8 + n0 / 8]
                       : __ldg(reinterpret_cast<const uint4*>(src + (long long)r * p.in + n0));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Bytes16 o;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          o.b[e] = (int8_t)(int)rintf(__fmul_rn(__bfloat162float(x[e].h[i]), inv));
        dst[g * 8 + i] = o.u;
      }
    }
  }
}

// Keeps the compiler from moving reads or writes of an int32 accumulator
// across the wgmma fence, commit and wait around it.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x n s32) (+)= A (64 x 32 s8) . B (n x 32 s8)^T, both K-major in
// shared memory (8-bit wgmma has no transpose); acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_i8_n16(int (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n32(int (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n48(int (&d)[24], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n64(int (&d)[32], uint64_t da, uint64_t db, int acc) {
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
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n80(int (&d)[40], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n96(int (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n112(int (&d)[56], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_i8_n128(int (&d)[64], uint64_t da, uint64_t db, int acc) {
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
      : "l"(da), "l"(db), "r"(acc));
}

// O (+)= P . V for a head of HN * 16 padded columns.
template <int HN>
__device__ __forceinline__ void wgmma_pv(int (&d)[HN * 8], uint64_t da, uint64_t db, int acc) {
  if constexpr (HN == 1) wgmma_i8_n16(d, da, db, acc);
  else if constexpr (HN == 2) wgmma_i8_n32(d, da, db, acc);
  else if constexpr (HN == 3) wgmma_i8_n48(d, da, db, acc);
  else if constexpr (HN == 4) wgmma_i8_n64(d, da, db, acc);
  else if constexpr (HN == 5) wgmma_i8_n80(d, da, db, acc);
  else if constexpr (HN == 6) wgmma_i8_n96(d, da, db, acc);
  else if constexpr (HN == 7) wgmma_i8_n112(d, da, db, acc);
  else wgmma_i8_n128(d, da, db, acc);
}

// A logit of the int32 product: f32(acc) * (qs * (sq * sk)).
__device__ __forceinline__ float logit(int acc, float cl) {
  return __fmul_rn(__int2float_rn(acc), cl);
}
__device__ __forceinline__ float soft_exp(float x, int exp2) { return exp2 ? exp2f(x) : expf(x); }
// p = rint((e * (1 / sum)) * 127) (0 for a pad key's e = 0), e = exp(l - m).
__device__ __forceinline__ int8_t p_of_e(float e, float inv) {
  return (int8_t)(int)rintf(__fmul_rn(__fmul_rn(e, inv), 127.0f));
}
__device__ __forceinline__ int8_t p_of(float l, float m, float inv, int exp2) {
  return p_of_e(soft_exp(__fsub_rn(l, m), exp2), inv);
}

__device__ __forceinline__ void quad_max(float& a, float& b) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
}
__device__ __forceinline__ void quad_sum(float& a, float& b) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
}

// The byte (r, key) of a 64-row P tile of nk keys, K-major core matrices.
__device__ __forceinline__ int p_off(int r, int key, int nk) {
  return (r >> 3) * (nk * 8) + (key >> 4) * 128 + (r & 7) * 16 + (key & 15);
}

// The epilogue: the accumulators (rows r0 and r0 + 8 of the tile, columns 8
// j + 2 t4 and + 1) quantized as clip(rint(f32(acc) * cv), +-127) into the
// staging tile Os (64 x hd), then the tile's rows < N stored 8 bytes a thread.
template <int HN>
__device__ __forceinline__ void store_int8_tile(const int (&o)[HN * 8], int8_t* Os,
                                                const I8Args& p, int b, int h, int qt, int r0,
                                                int t4, float cv) {
  const int hd = p.hd;
#pragma unroll
  for (int j = 0; j < 2 * HN; ++j) {
    const int col = 8 * j + 2 * t4;
    if (col < hd) {
      char2 a, c;
      a.x = quantize(__int2float_rn(o[4 * j]), cv);
      a.y = quantize(__int2float_rn(o[4 * j + 1]), cv);
      c.x = quantize(__int2float_rn(o[4 * j + 2]), cv);
      c.y = quantize(__int2float_rn(o[4 * j + 3]), cv);
      *reinterpret_cast<char2*>(Os + r0 * hd + col) = a;
      *reinterpret_cast<char2*>(Os + (r0 + 8) * hd + col) = c;
    }
  }
  __syncthreads();
  const int rows = min(IKB, p.N - qt * IKB), c8 = hd / 8;
  int8_t* out = p.out + (long long)b * p.ob + (long long)h * p.oh + (long long)qt * IKB * p.on;
  for (int i = threadIdx.x; i < rows * c8; i += IT) {
    const int r = i / c8, c = (i - r * c8) * 8;
    *reinterpret_cast<uint2*>(out + r * p.on + c) = *reinterpret_cast<const uint2*>(Os + r * hd + c);
  }
}

// N <= MAX_NK_SHORT: grid (Nk / 64, H, B), NCH = Nk / 64 accumulators of
// logits (up to 192 keys in 128 registers a thread, so four CTAs share an
// SM). Shared memory: the Q tile (64 x Hk), K (Nk x Hk), Vt (Hv x Nk), P (64
// x Nk), two mbarriers (Q + K, V).
template <int NCH, int HN>
__global__ void __launch_bounds__(IT, NCH <= 3 ? 4 : 3) attention_int8_kernel(const I8Args p) {
  constexpr int Hv = HN * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int N = p.N, exp2 = p.exp2;
  const Tiles T = tiles_of(N, p.hd);
  constexpr int Nk = NCH * IKB;
  const int Hk = T.Hk;
  const long long bh = (long long)b * p.H + h, BH = (long long)p.B * p.H;
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + IKB * Hk;
  unsigned char* Vs = Ks + Nk * Hk;
  unsigned char* Ps = Vs + Nk * Hv;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ps + IKB * Nk);
  const uint32_t q_s = smem_u32(Qs), k_s = smem_u32(Ks), v_s = smem_u32(Vs), p_s = smem_u32(Ps);
  const uint32_t bar_qk = smem_u32(bars), bar_v = smem_u32(bars + 1);
  if (tid == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_qk, (IKB + Nk) * Hk);
    bulk_load(q_s, p.tiles + bh * T.qk_head + (long long)qt * IKB * Hk, IKB * Hk, bar_qk);
    bulk_load(k_s, p.tiles + (BH + bh) * T.qk_head, Nk * Hk, bar_qk);
    mbar_arrive_expect_tx(bar_v, Nk * Hv);
    bulk_load(v_s, p.tiles + 2 * BH * T.qk_head + bh * T.v_head, Nk * Hv, bar_v);
  }
  const float* sc = p.scales + bh * 3;
  const float cl = __fmul_rn(p.qs, __fmul_rn(sc[0], sc[1]));
  const float cv = __fmul_rn(__fmul_rn(sc[2], kRecip127), __fdiv_rn(1.0f, *p.out_scale));

  // S = Qi . Ki^T: NCH accumulators of 64 x 64 int32, Hk / 32 k32 steps.
  int s[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[c][i] = 0;
    fence_acc(s[c]);
  }
  mbar_wait(bar_qk, 0);
  wgmma_fence();
  for (int kk = 0; kk < Hk / 32; ++kk) {
    const uint64_t da = desc(q_s + kk * 256, 128, Hk * 8);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_i8_n64(s[c], da, desc(k_s + c * IKB * Hk + kk * 256, 128, Hk * 8), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_acc(s[c]);

  // The softmax of rows r0 and r0 + 8 (this thread's keys 8 j + 2 t4 + e of
  // each block), reduced over the quad; p into shared memory.
  const int r0 = warp * 16 + g;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c * IKB + 8 * j + 2 * t4 + e < N) {
          m0 = fmaxf(m0, logit(s[c][4 * j + e], cl));
          m1 = fmaxf(m1, logit(s[c][4 * j + 2 + e], cl));
        }
  quad_max(m0, m1);
  // e in place of the logits (as f32 bits; 0 for pad keys), summed
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = c * IKB + 8 * j + 2 * t4 + e < N;
        const float e0 = in ? soft_exp(__fsub_rn(logit(s[c][4 * j + e], cl), m0), exp2) : 0.0f;
        const float e1 = in ? soft_exp(__fsub_rn(logit(s[c][4 * j + 2 + e], cl), m1), exp2) : 0.0f;
        s[c][4 * j + e] = __float_as_int(e0);
        s[c][4 * j + 2 + e] = __float_as_int(e1);
        l0 = __fadd_rn(l0, e0);
        l1 = __fadd_rn(l1, e1);
      }
  quad_sum(l0, l1);
  const float inv0 = __fdiv_rn(1.0f, l0), inv1 = __fdiv_rn(1.0f, l1);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = c * IKB + 8 * j + 2 * t4;
      const int* x = &s[c][4 * j];
      char2 a, d;
      a.x = p_of_e(__int_as_float(x[0]), inv0);
      a.y = p_of_e(__int_as_float(x[1]), inv0);
      d.x = p_of_e(__int_as_float(x[2]), inv1);
      d.y = p_of_e(__int_as_float(x[3]), inv1);
      *reinterpret_cast<char2*>(Ps + p_off(r0, key, Nk)) = a;
      *reinterpret_cast<char2*>(Ps + p_off(r0 + 8, key, Nk)) = d;
    }
  fence_proxy_async();
  __syncthreads();

  // O = Pi . Vi over the k32 steps up to N (the rest have pi = 0).
  int o[HN * 8];
#pragma unroll
  for (int i = 0; i < HN * 8; ++i) o[i] = 0;
  fence_acc(o);
  mbar_wait(bar_v, 0);
  wgmma_fence();
  const int nks = (N + 31) / 32;
  for (int ks = 0; ks < nks; ++ks)
    wgmma_pv<HN>(o, desc(p_s + ks * 256, 128, Nk * 8),
                 desc(v_s + (ks >> 1) * (Hv * IKB) + (ks & 1) * 256, 128, 512), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  store_int8_tile<HN>(o, reinterpret_cast<int8_t*>(Ks), p, b, h, qt, r0, t4, cv);
}

// N > MAX_NK_SHORT: the same grid and CTA, three sweeps over the Nk / 64 key
// blocks (the header says why). Shared memory: the Q tile, STAGES stages of
// a K block (64 x Hk) and a V block (Hv x 64), the P block (64 x 64), the
// stages' mbarriers and Q's.
template <int HN>
__global__ void __launch_bounds__(IT) attention_int8_long_kernel(const I8Args p) {
  constexpr int Hv = HN * 16, VBLK = IKB * Hv;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int N = p.N, exp2 = p.exp2;
  const Tiles T = tiles_of(N, p.hd);
  const int Hk = T.Hk, nb = T.Nk / IKB, total = 3 * nb, KBLK = IKB * Hk, SB = KBLK + VBLK;
  const long long bh = (long long)b * p.H + h, BH = (long long)p.B * p.H;
  const int8_t* kg = p.tiles + (BH + bh) * T.qk_head;
  const int8_t* vg = p.tiles + 2 * BH * T.qk_head + bh * T.v_head;
  unsigned char* Qs = smem;
  unsigned char* St = Qs + KBLK;
  unsigned char* Ps = St + STAGES * SB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ps + IKB * IKB);  // STAGES full + Q's
  const uint32_t q_s = smem_u32(Qs), st_s = smem_u32(St), p_s = smem_u32(Ps);
  const uint32_t bar_q = smem_u32(bars + STAGES);
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // iteration it of the sweeps: key block it % nb; the third sweep loads V too
  auto issue = [&](int it) {
    const int stg = it % STAGES, blk = it % nb;
    const bool with_v = it >= 2 * nb;
    const uint32_t bar = smem_u32(bars + stg), dst = st_s + stg * SB;
    mbar_arrive_expect_tx(bar, KBLK + (with_v ? VBLK : 0));
    bulk_load(dst, kg + (long long)blk * KBLK, KBLK, bar);
    if (with_v) bulk_load(dst + KBLK, vg + (long long)blk * VBLK, VBLK, bar);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_q, KBLK);
    bulk_load(q_s, p.tiles + bh * T.qk_head + (long long)qt * KBLK, KBLK, bar_q);
    for (int i = 0; i < STAGES && i < total; ++i) issue(i);
  }
  const float* sc = p.scales + bh * 3;
  const float cl = __fmul_rn(p.qs, __fmul_rn(sc[0], sc[1]));
  const float cv = __fmul_rn(__fmul_rn(sc[2], kRecip127), __fdiv_rn(1.0f, *p.out_scale));
  mbar_wait(bar_q, 0);

  int s[32];
  // S = Qi . Ki^T of the block of iteration it, once its stage has landed
  auto logits_of = [&](int it) {
    const int stg = it % STAGES;
    mbar_wait(smem_u32(bars + stg), (it / STAGES) & 1);
    fence_acc(s);
    wgmma_fence();
    for (int kk = 0; kk < Hk / 32; ++kk)
      wgmma_i8_n64(s, desc(q_s + kk * 256, 128, Hk * 8), desc(st_s + stg * SB + kk * 256, 128, Hk * 8),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
  };
  // the stage of iteration it is free: refill it STAGES iterations ahead
  auto release = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + STAGES < total) issue(it + STAGES);
  };

  const int r0 = warp * 16 + g;
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int blk = 0; blk < nb; ++blk) {  // 1: the exact row max
    logits_of(blk);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (blk * IKB + 8 * j + 2 * t4 + e < N) {
          m0 = fmaxf(m0, logit(s[4 * j + e], cl));
          m1 = fmaxf(m1, logit(s[4 * j + 2 + e], cl));
        }
    release(blk);
  }
  quad_max(m0, m1);
  float l0 = 0.0f, l1 = 0.0f;
  for (int blk = 0; blk < nb; ++blk) {  // 2: the sum of e with that max
    logits_of(nb + blk);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (blk * IKB + 8 * j + 2 * t4 + e < N) {
          l0 = __fadd_rn(l0, soft_exp(__fsub_rn(logit(s[4 * j + e], cl), m0), exp2));
          l1 = __fadd_rn(l1, soft_exp(__fsub_rn(logit(s[4 * j + 2 + e], cl), m1), exp2));
        }
    release(nb + blk);
  }
  quad_sum(l0, l1);
  const float inv0 = __fdiv_rn(1.0f, l0), inv1 = __fdiv_rn(1.0f, l1);
  int o[HN * 8];
#pragma unroll
  for (int i = 0; i < HN * 8; ++i) o[i] = 0;
  for (int blk = 0; blk < nb; ++blk) {  // 3: p, its quantization, O += Pi . Vi
    const int it = 2 * nb + blk;
    logits_of(it);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = 8 * j + 2 * t4, kabs = blk * IKB + key;
      char2 a, d;
      a.x = kabs < N ? p_of(logit(s[4 * j], cl), m0, inv0, exp2) : 0;
      a.y = kabs + 1 < N ? p_of(logit(s[4 * j + 1], cl), m0, inv0, exp2) : 0;
      d.x = kabs < N ? p_of(logit(s[4 * j + 2], cl), m1, inv1, exp2) : 0;
      d.y = kabs + 1 < N ? p_of(logit(s[4 * j + 3], cl), m1, inv1, exp2) : 0;
      *reinterpret_cast<char2*>(Ps + p_off(r0, key, IKB)) = a;
      *reinterpret_cast<char2*>(Ps + p_off(r0 + 8, key, IKB)) = d;
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t vb = st_s + (it % STAGES) * SB + KBLK;
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < IKB / 32; ++ks)
      wgmma_pv<HN>(o, desc(p_s + ks * 256, 128, IKB * 8), desc(vb + ks * 256, 128, 512), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    release(it);
  }
  store_int8_tile<HN>(o, reinterpret_cast<int8_t*>(Qs), p, b, h, qt, r0, t4, cv);
}

typedef void (*I8Kernel)(const I8Args);

template <int HN>
I8Kernel int8_kernel(int N) {
  switch (round64(N) / IKB) {
    case 1: return attention_int8_kernel<1, HN>;
    case 2: return attention_int8_kernel<2, HN>;
    case 3: return attention_int8_kernel<3, HN>;
    case 4: return attention_int8_kernel<4, HN>;
    default: return attention_int8_long_kernel<HN>;
  }
}

int int8_attention_smem(int N, int hd) {
  const Tiles t = tiles_of(N, hd);
  if (N <= MAX_NK_SHORT) return (IKB + t.Nk) * t.Hk + t.Nk * t.Hv + IKB * t.Nk + 16;
  return IKB * t.Hk + STAGES * IKB * (t.Hk + t.Hv) + IKB * IKB + 8 * (STAGES + 1);
}

I8Args i8_args(const void* q, const void* k, const void* v, long long ib, long long ih,
               long long in, int B, int H, int N, int hd, void* tiles, void* scales) {
  I8Args p = {};
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.ib = ib;
  p.ih = ih;
  p.in = in;
  p.tiles = (int8_t*)tiles;
  p.scales = (float*)scales;
  p.B = B;
  p.H = H;
  p.N = N;
  p.hd = hd;
  return p;
}

bool bad_i8_args(const I8Args& p) {
  return p.N <= 0 || p.hd <= 0 || p.hd > MAX_HD || p.hd % 8 || p.B <= 0 || p.H <= 0 ||
         p.B > 65535 || p.H > 65535 || p.ib % 8 || p.ih % 8 || p.in % 8 ||
         (uintptr_t)p.q % 16 || (uintptr_t)p.k % 16 || (uintptr_t)p.v % 16 ||
         (uintptr_t)p.tiles % 16 || (uintptr_t)p.scales % 4;
}

int launch_quantize_heads(const I8Args& p, cudaStream_t stream) {
  const int cache_rows = p.N < PRE_CACHE / (2 * p.hd) ? p.N : PRE_CACHE / (2 * p.hd);
  const int smem = cache_rows * p.hd * 2;
  cudaError_t err = cudaFuncSetAttribute(quantize_heads_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  quantize_heads_kernel<<<dim3(3, p.H, p.B), PRE_T, smem, stream>>>(p, cache_rows);
  return (int)cudaGetLastError();
}

}  // namespace


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

// The int8 products' pre-pass alone: q, k, v bf16 (B, H, N, hd) through the
// element strides (ib, ih, in), hd contiguous, into ``tiles`` (B * H * Nk *
// (2 Hk + Hv) bytes, the layout of quantize_heads_kernel) and ``scales`` (B,
// H, 3) f32. hd % 8 == 0 and hd <= 128, the strides multiples of 8, the
// pointers 16-byte aligned.
extern "C" int hyt_quantize_heads(const void* q, const void* k, const void* v, long long ib,
                                  long long ih, long long in, int B, int H, int N, int hd,
                                  void* tiles, void* scales, void* stream) {
  const I8Args p = i8_args(q, k, v, ib, ih, in, B, H, N, hd, tiles, scales);
  if (bad_i8_args(p)) return (int)cudaErrorInvalidValue;
  return launch_quantize_heads(p, (cudaStream_t)stream);
}

// K3's attention under HYT_ATTN_MATH=int8 (with exp2: HYT_SOFTMAX=exp2 or
// exp2p): the pre-pass, then the attention launch, any N >= 1; the arguments
// as hyt_attention_flavour's and hyt_quantize_heads' (the scratch of both
// launches); scale: qs in f32.
extern "C" int hyt_attention_int8(const void* q, const void* k, const void* v, long long ib,
                                  long long ih, long long in, void* out, const void* out_scale,
                                  long long ob, long long oh, long long on, int B, int H, int N,
                                  int hd, float scale, int exp2, void* tiles, void* scales,
                                  void* stream) {
  I8Args p = i8_args(q, k, v, ib, ih, in, B, H, N, hd, tiles, scales);
  p.out = (int8_t*)out;
  p.ob = ob;
  p.oh = oh;
  p.on = on;
  p.out_scale = (const float*)out_scale;
  p.qs = scale;
  p.exp2 = exp2;
  if (bad_i8_args(p) || ob % 8 || oh % 8 || on % 8 || (uintptr_t)out % 16 || !out_scale)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = launch_quantize_heads(p, st);
  if (rc) return rc;
  I8Kernel kernel;
  switch (round16(hd) / 16) {
    case 1: kernel = int8_kernel<1>(N); break;
    case 2: kernel = int8_kernel<2>(N); break;
    case 3: kernel = int8_kernel<3>(N); break;
    case 4: kernel = int8_kernel<4>(N); break;
    case 5: kernel = int8_kernel<5>(N); break;
    case 6: kernel = int8_kernel<6>(N); break;
    case 7: kernel = int8_kernel<7>(N); break;
    default: kernel = int8_kernel<8>(N); break;
  }
  const int smem = int8_attention_smem(N, hd);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(round64(N) / IKB, H, B), IT, smem, st>>>(p);
  return (int)cudaGetLastError();
}
