// The device code of short_attention.cu (its header says the design): the
// constants, AttnArgs, the softmax flavours, the bf16 and f32 attention
// kernels and their launch. Included by short_attention.cu and by
// attention_flavours.cu, which builds the bf16 kernels with K3's flavours.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int QT = 64;         // query rows of a warpgroup: one wgmma M extent
constexpr int TPC = 3;         // query tiles of a bf16 CTA, one warpgroup each
constexpr int CT = 128 * TPC;  // threads of the bf16 kernel
constexpr int AT = 256;        // threads of the f32 kernel
constexpr int MAX_N1 = 256;    // keys of the single-pass bf16 kernel: four n64 accumulators
constexpr int KB = 64;         // keys of a block in the key-block forms
constexpr int MAX_HD = 128;    // head width of the bf16 kernels: eight n16 accumulators

// K3's softmax flavours (JAX's HYT_SOFTMAX; attention_flavours.cu builds the
// kernels below with the other two for K3's int8 output): FL_EXP2 takes
// exp2 of the max-shifted logits (the wrapper folds log2(e) into the q
// prescale); FL_EXP2P besides leaves e unnormalised into P V and scales each
// row's output by 1 / its sum in the epilogue. exp2f is CUDA's full-range
// exp2 (not ex2.approx.ftz): within 2 ulp of the correctly rounded result,
// as expf is; the plain version's torch.exp2 is within 1 ulp.
enum Flavour { FL_EXP = 0, FL_EXP2 = 1, FL_EXP2P = 2 };
template <int FL>
__device__ __forceinline__ float flavour_exp(float x) {
  if constexpr (FL == FL_EXP) return expf(x);
  else return exp2f(x);
}

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// bf16 up to MAX_N1 keys: K and V (Nk x Hp), the Q tiles (TPC * QT x Hp),
// two mbarriers; beyond: the Q tiles, two stages of a K and a V block (KB x
// Hp each), three mbarriers. f32: a K block (KB x (hd + 1)), a V block (KB x
// hd), the Q tile and the output tile (QT x hd each), a block of logits,
// later probabilities (QT x KB), and each row's max and sum (QT each).
__host__ __device__ __forceinline__ int smem_bytes(int N, int hd, int elem) {
  if (elem == 4) return (round4(KB * (hd + 1)) + KB * hd + 2 * QT * hd + QT * KB + 2 * QT) * 4;
  const int Hp = round16(hd);
  if (N > MAX_N1) return (TPC * QT + 4 * KB) * Hp * 2 + 24;
  const int Nk = (N + 63) & ~63;
  return (2 * Nk + TPC * QT) * Hp * 2 + 16;
}

struct AttnArgs {
  const void *q, *k, *v;   // bf16 or f32
  long long ib, ih, in;  // element strides of q, k and v: crop, head, row
  void* out;
  long long ob, oh, on;  // element strides of the output
  int N, hd;
  float scale;             // hd^-0.5 rounded to the inputs' dtype
  const float* out_scale;  // (1,) scale of the int8 output, on the device
  int out_kind;            // 0 bf16, 1 f32, 2 int8 (read by the key-block bf16 kernel)
};

// ------------------------------------------------------ sm_90 primitives
// (the mbarriers, fences and wgmma fences shared with the GEMMs: hopper.cuh)
// 16 bytes global -> shared, asynchronously; bytes past src_bytes are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The barrier's arrival of this thread fires once all its earlier cp.async
// copies have landed (the count set at init includes it).
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence, commit and wait around it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor of the unswizzled layout: start address,
// leading byte offset (between core matrices along the reduction axis) and
// stride byte offset (between core matrices along M or N), each in 16-byte
// units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d (64 x 64 f32) (+)= A (64 x 16 bf16, K-major, shared) . B (16 x 64 bf16,
// K-major, shared).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16 f32) += A (64 x 16 bf16, registers) . B (16 x 16 bf16, MN-major
// in shared memory: transposed).
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of element (r, c) in the core-matrix layout of a matrix with
// Hp columns: 8-row groups Hp * 16 bytes apart, 8-column core matrices 128
// bytes apart, rows of a core matrix 16 bytes apart.
__device__ __forceinline__ uint32_t cm_off(int r, int c, int Hp) {
  return (uint32_t)((r >> 3) * (Hp * 16) + (c >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2);
}

// The epilogue: 8 adjacent outputs of a row, rounded to the output type or
// quantized by inv, in one or two vector stores.
__device__ __forceinline__ void store8(bf16* out, const float (&o)[8], float) {
  Pack8 pk;
#pragma unroll
  for (int i = 0; i < 8; ++i) pk.h[i] = __float2bfloat16_rn(o[i]);
  *reinterpret_cast<uint4*>(out) = pk.u;
}
__device__ __forceinline__ void store8(float* out, const float (&o)[8], float) {
  reinterpret_cast<float4*>(out)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store8(int8_t* out, const float (&o)[8], float inv) {
  union {
    uint2 u;
    int8_t b[8];
  } pk;
#pragma unroll
  for (int i = 0; i < 8; ++i) pk.b[i] = quantize(o[i], inv);
  *reinterpret_cast<uint2*>(out) = pk.u;
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// Softmax of this thread's logits, in place, then p rounded to bf16 as the A
// fragments of the k16 steps of P . V. The thread holds rows g and g + 8 of
// its warp's 16 (g = lane / 4), columns 8 j + 2 t and + 1 of each n8 block j
// (t = lane % 4): s[c][4 j' + e], j' the block within chunk c, e = 0, 1 row g
// and e = 2, 3 row g + 8. MASKED leaves keys past N out (only the last chunk
// can hold them); with N = 64 NCH the mask is compiled away.
// FL_EXP2P packs e unnormalised and leaves the rows' 1 / sum in inv0, inv1.
template <int NCH, bool MASKED, int FL = FL_EXP>
__device__ __forceinline__ void softmax_to_p(float (&s)[NCH][32], uint32_t (&pa)[4 * NCH][4],
                                             int N, int t4, float& inv0, float& inv1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!MASKED || c < NCH - 1 || c * 64 + 8 * j + 2 * t4 + e < N) {
          m0 = fmaxf(m0, s[c][4 * j + e]);
          m1 = fmaxf(m1, s[c][4 * j + 2 + e]);
        }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = !MASKED || c < NCH - 1 || c * 64 + 8 * j + 2 * t4 + e < N;
        const float e0 = in ? flavour_exp<FL>(__fsub_rn(s[c][4 * j + e], m0)) : 0.0f;
        const float e1 = in ? flavour_exp<FL>(__fsub_rn(s[c][4 * j + 2 + e], m1)) : 0.0f;
        s[c][4 * j + e] = e0;
        s[c][4 * j + 2 + e] = e1;
        l0 = __fadd_rn(l0, e0);
        l1 = __fadd_rn(l1, e1);
      }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, o));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, o));
  }
  inv0 = __fdiv_rn(1.0f, l0);
  inv1 = __fdiv_rn(1.0f, l1);
  const float n0 = FL == FL_EXP2P ? 1.0f : inv0, n1 = FL == FL_EXP2P ? 1.0f : inv1;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int kl = 0; kl < 4; ++kl) {
      const float* x = &s[c][8 * kl];
      pa[4 * c + kl][0] = pack_bf16(__fmul_rn(x[0], n0), __fmul_rn(x[1], n0));
      pa[4 * c + kl][1] = pack_bf16(__fmul_rn(x[2], n1), __fmul_rn(x[3], n1));
      pa[4 * c + kl][2] = pack_bf16(__fmul_rn(x[4], n0), __fmul_rn(x[5], n0));
      pa[4 * c + kl][3] = pack_bf16(__fmul_rn(x[6], n1), __fmul_rn(x[7], n1));
    }
}

// The epilogue of a warpgroup's outputs o (64 rows x HC * 16 columns, the
// m64n16 accumulator layout): in each quad, thread t takes the 8 columns
// 16 j + 8 (t / 2) .. + 7 of row g (t even) or g + 8 (t odd) from the quad's
// four threads and stores them at once. ``row`` is that row's index, ``out``
// its column 0.
template <int HC, typename OutT>
__device__ __forceinline__ void store_rows(const float (&o)[HC][8], int N, int hd, int row,
                                           OutT* out, float inv_out, int t4) {
#pragma unroll
  for (int j = 0; j < HC; ++j) {
    float2 x[4], got[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = make_float2(o[j][4 * (k >> 1) + 2 * (k & 1)], o[j][4 * (k >> 1) + 2 * (k & 1) + 1]);
    got[0] = pick4(x, t4);
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      const float2 send = pick4(x, t4 ^ r);
      got[r] = make_float2(__shfl_xor_sync(0xffffffffu, send.x, r),
                           __shfl_xor_sync(0xffffffffu, send.y, r));
    }
    float v[8];
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const float2 y = pick4(got, src ^ t4);  // columns 2 src, 2 src + 1
      v[2 * src] = y.x;
      v[2 * src + 1] = y.y;
    }
    const int col = 16 * j + 8 * (t4 >> 1);
    if (row < N && col < hd) store8(out + col, v, inv_out);
  }
}

// O = P . Vs for a head of HC * 16 padded columns, once V has landed, then
// the epilogue (store_rows).
template <int NCH, int HC, typename OutT>
__device__ __forceinline__ void pv_store(const uint32_t (&pa)[4 * NCH][4], uint32_t v_s,
                                         uint32_t bar_v, int N, int hd, int row, OutT* out,
                                         float inv_out, int t4) {
  constexpr int Hp = HC * 16;
  float o[HC][8];
#pragma unroll
  for (int j = 0; j < HC; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[j][i] = 0.0f;
    fence_regs(o[j]);
  }
  // the k16 steps over the keys up to N rounded to 16 (the rest have p = 0)
  const int nks = (N + 15) / 16;
  mbar_wait(bar_v, 0);
  fence_proxy_async();
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * NCH; ++ks)
    if (ks < nks) {
#pragma unroll
      for (int j = 0; j < HC; ++j)
        wgmma_rs_n16_tb(o[j], pa[ks], desc(v_s + ks * 2 * (Hp * 16) + j * 256, Hp * 16, 128));
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < HC; ++j) fence_regs(o[j]);
  store_rows<HC>(o, N, hd, row, out, inv_out, t4);
}

// bf16 inputs: NCH n64 accumulators of logits (N <= 64 * NCH); FL the
// softmax flavour (FL_EXP2P with an int8 output only).
template <int NCH, typename OutT, int FL = FL_EXP>
__global__ void __launch_bounds__(CT) attention_bf16_kernel(const AttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* pq = reinterpret_cast<const bf16*>(p.q);
  const bf16* pk = reinterpret_cast<const bf16*>(p.k);
  const bf16* pv = reinterpret_cast<const bf16*>(p.v);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * TPC * QT, qt = blockIdx.x * TPC + wg;  // this warpgroup's tile
  const int N = p.N, hd = p.hd, Hp = round16(hd), hc = Hp / 16, cpr = Hp / 8;
  constexpr int Nk = 64 * NCH;

  unsigned char* Ks = smem;               // Nk x Hp
  unsigned char* Vs = Ks + Nk * Hp * 2;   // Nk x Hp
  unsigned char* Qs = Vs + Nk * Hp * 2;   // TPC * QT x Hp
  uint64_t* bars = reinterpret_cast<uint64_t*>(Qs + TPC * QT * Hp * 2);
  const uint32_t k_s = smem_u32(Ks), v_s = smem_u32(Vs), q_s = smem_u32(Qs);
  const uint32_t bar_qk = smem_u32(bars), bar_v = smem_u32(bars + 1);
  if (tid == 0) {
    mbar_init(bar_qk, CT);
    mbar_init(bar_v, CT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Asynchronous loads: Q tile and K on one barrier, V on the other.
  const long long base = (long long)b * p.ib + (long long)h * p.ih;
  for (int c = tid; c < TPC * QT * cpr; c += CT) {
    const int r = c / cpr, cc = (c % cpr) * 8, row = q0 + r;
    const bool in = row < N && cc < hd;
    cp_async16(q_s + cm_off(r, cc, Hp), pq + (in ? base + (long long)row * p.in + cc : 0),
               in ? 16 : 0);
  }
  for (int c = tid; c < Nk * cpr; c += CT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    const bool in = r < N && cc < hd;
    cp_async16(k_s + cm_off(r, cc, Hp), pk + (in ? base + (long long)r * p.in + cc : 0),
               in ? 16 : 0);
  }
  mbar_arrive_on_copies(bar_qk);
  for (int c = tid; c < Nk * cpr; c += CT) {
    const int r = c / cpr, cc = (c % cpr) * 8;
    const bool in = r < N && cc < hd;
    cp_async16(v_s + cm_off(r, cc, Hp), pv + (in ? base + (long long)r * p.in + cc : 0),
               in ? 16 : 0);
  }
  mbar_arrive_on_copies(bar_v);

  // q * scale, rounded to bf16, in place.
  mbar_wait(bar_qk, 0);
  for (int c = tid; c < TPC * QT * cpr; c += CT) {
    uint4* qp = reinterpret_cast<uint4*>(Qs + cm_off(c / cpr, (c % cpr) * 8, Hp));
    Pack8 v;
    v.u = *qp;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v.h[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(v.h[i]), p.scale));
    *qp = v.u;
  }
  fence_proxy_async();
  __syncthreads();

  // S = Qs . Ks^T: NCH accumulators of 64 x 64 f32, hc k16 steps.
  float s[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[c][i] = 0.0f;
    fence_regs(s[c]);
  }
  wgmma_fence();
  for (int kk = 0; kk < hc; ++kk) {
    const uint64_t da = desc(q_s + wg * 8 * (Hp * 16) + kk * 256, 128, Hp * 16);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_ss_n64(s[c], da, desc(k_s + c * 8 * (Hp * 16) + kk * 256, 128, Hp * 16), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NCH; ++c) fence_regs(s[c]);

  // Softmax in registers, then P . V and the epilogue at the head's width.
  const int t4 = lane & 3;
  uint32_t pa[4 * NCH][4];
  float inv0, inv1;
  if (N == 64 * NCH)
    softmax_to_p<NCH, false, FL>(s, pa, N, t4, inv0, inv1);
  else
    softmax_to_p<NCH, true, FL>(s, pa, N, t4, inv0, inv1);
  const int row = qt * QT + warp * 16 + (lane >> 2) + (t4 & 1) * 8;
  OutT* out = reinterpret_cast<OutT*>(p.out) + (long long)b * p.ob + (long long)h * p.oh +
              (long long)row * p.on;
  float inv_out = p.out_scale ? __fdiv_rn(1.0f, *p.out_scale) : 0.0f;
  // exp2p: res = (e . v) * (1 / sum * 1 / s), the row this thread stores
  if (FL == FL_EXP2P) inv_out = __fmul_rn((t4 & 1) ? inv1 : inv0, inv_out);
  switch (hc) {
    case 1: pv_store<NCH, 1>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    case 2: pv_store<NCH, 2>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    case 3: pv_store<NCH, 3>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    case 4: pv_store<NCH, 4>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    case 5: pv_store<NCH, 5>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    case 6: pv_store<NCH, 6>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    case 7: pv_store<NCH, 7>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
    default: pv_store<NCH, 8>(pa, v_s, bar_v, N, hd, row, out, inv_out, t4); break;
  }
}

// bf16 inputs, N > MAX_N1 keys: the key-block form. The same CTA of three
// warpgroups per (192 query rows, head, crop) and the same Q tiles, but K and
// V stream through two stages of shared memory a block of KB keys at a time
// (cp.async on one mbarrier a stage; the next block's copies are in flight
// while this one's products run), in two passes over the blocks:
//  1. S = Q K^T per block; each row's max m and sum l, the sum rescaled by
//     exp(m_old - m_new) whenever the max grows;
//  2. S again (the same wgmma, so the same logits), p = exp(s - m) * (1 / l)
//     rounded to bf16, and O += P V on wgmma (V streamed beside K).
// p is normalised and rounded before P V, as the single-pass kernel and the
// TPU kernel do; a one-pass flash loop (unnormalised e.v rescaled, divided at
// the end) would round elsewhere. The logit accumulator is one n64 (32
// registers), the outputs HC n16 ones, whatever N is; the output type is read
// at run time in the epilogue (it is outside the loop).
template <int HC, int FL = FL_EXP>
__global__ void __launch_bounds__(CT) attention_bf16_long_kernel(const AttnArgs p) {
  constexpr int Hp = HC * 16, cpr = Hp / 8, BLK = KB * Hp * 2;  // bytes of a K or V block
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* pq = reinterpret_cast<const bf16*>(p.q);
  const bf16* pk = reinterpret_cast<const bf16*>(p.k);
  const bf16* pv = reinterpret_cast<const bf16*>(p.v);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * TPC * QT, qt = blockIdx.x * TPC + wg;
  const int N = p.N, hd = p.hd, nb = (N + KB - 1) / KB;

  unsigned char* Qs = smem;                                           // TPC * QT x Hp
  unsigned char* St = Qs + TPC * QT * Hp * 2;                         // 2 x (K, V blocks)
  uint64_t* bars = reinterpret_cast<uint64_t*>(St + 4 * BLK);         // Q, stage 0, stage 1
  const uint32_t q_s = smem_u32(Qs), st_s = smem_u32(St), bar_q = smem_u32(bars);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(bars + i), CT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long base = (long long)b * p.ib + (long long)h * p.ih;
  for (int c = tid; c < TPC * QT * cpr; c += CT) {
    const int r = c / cpr, cc = (c % cpr) * 8, row = q0 + r;
    const bool in = row < N && cc < hd;
    cp_async16(q_s + cm_off(r, cc, Hp), pq + (in ? base + (long long)row * p.in + cc : 0),
               in ? 16 : 0);
  }
  mbar_arrive_on_copies(bar_q);
  // Step it of the 2 nb: key block it % nb into stage it & 1, K in both
  // passes, V in the second.
  auto load = [&](int it) {
    const int k0 = (it % nb) * KB;
    const uint32_t ks = st_s + (it & 1) * 2 * BLK;
    for (int c = tid; c < KB * cpr; c += CT) {
      const int r = c / cpr, cc = (c % cpr) * 8, key = k0 + r;
      const bool in = key < N && cc < hd;
      const long long off = in ? base + (long long)key * p.in + cc : 0;
      cp_async16(ks + cm_off(r, cc, Hp), pk + off, in ? 16 : 0);
      if (it >= nb) cp_async16(ks + BLK + cm_off(r, cc, Hp), pv + off, in ? 16 : 0);
    }
    mbar_arrive_on_copies(smem_u32(bars + 1 + (it & 1)));
  };
  load(0);

  mbar_wait(bar_q, 0);  // q * scale, rounded to bf16, in place
  for (int c = tid; c < TPC * QT * cpr; c += CT) {
    uint4* qp = reinterpret_cast<uint4*>(Qs + cm_off(c / cpr, (c % cpr) * 8, Hp));
    Pack8 v;
    v.u = *qp;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v.h[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(v.h[i]), p.scale));
    *qp = v.u;
  }
  fence_proxy_async();
  __syncthreads();

  // rows g and g + 8 of this warp's 16: max, sum, then 1 / sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[HC][8];
#pragma unroll
  for (int j = 0; j < HC; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[j][i] = 0.0f;
    fence_regs(o[j]);
  }
  for (int it = 0; it < 2 * nb; ++it) {
    if (it + 1 < 2 * nb) load(it + 1);
    const uint32_t ks = st_s + (it & 1) * 2 * BLK;
    mbar_wait(smem_u32(bars + 1 + (it & 1)), (it >> 1) & 1);
    fence_proxy_async();
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HC; ++kk)
      wgmma_ss_n64(s, desc(q_s + wg * 8 * (Hp * 16) + kk * 256, 128, Hp * 16),
                   desc(ks + kk * 256, 128, Hp * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const int k0 = (it % nb) * KB;
    if (k0 + KB > N) {  // keys past N in the last block: out of max, sum and p
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t4 + (e & 1) >= N) s[4 * j + e] = -INFINITY;
    }
    if (it < nb) {
      float b0 = -INFINITY, b1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          b0 = fmaxf(b0, s[4 * j + e]);
          b1 = fmaxf(b1, s[4 * j + 2 + e]);
        }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        b0 = fmaxf(b0, __shfl_xor_sync(0xffffffffu, b0, w));
        b1 = fmaxf(b1, __shfl_xor_sync(0xffffffffu, b1, w));
      }
      const float n0 = fmaxf(m0, b0), n1 = fmaxf(m1, b1);
      float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          e0 = __fadd_rn(e0, flavour_exp<FL>(__fsub_rn(s[4 * j + e], n0)));
          e1 = __fadd_rn(e1, flavour_exp<FL>(__fsub_rn(s[4 * j + 2 + e], n1)));
        }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        e0 = __fadd_rn(e0, __shfl_xor_sync(0xffffffffu, e0, w));
        e1 = __fadd_rn(e1, __shfl_xor_sync(0xffffffffu, e1, w));
      }
      l0 = __fadd_rn(__fmul_rn(l0, flavour_exp<FL>(__fsub_rn(m0, n0))), e0);
      l1 = __fadd_rn(__fmul_rn(l1, flavour_exp<FL>(__fsub_rn(m1, n1))), e1);
      m0 = n0;
      m1 = n1;
      if (it == nb - 1) {
        l0 = __fdiv_rn(1.0f, l0);
        l1 = __fdiv_rn(1.0f, l1);
      }
    } else {
      uint32_t pa[4][4];
#pragma unroll
      for (int kl = 0; kl < 4; ++kl) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = flavour_exp<FL>(__fsub_rn(s[8 * kl + i], (i & 2) ? m1 : m0));
          x[i] = FL == FL_EXP2P ? e : __fmul_rn(e, (i & 2) ? l1 : l0);
        }
        pa[kl][0] = pack_bf16(x[0], x[1]);
        pa[kl][1] = pack_bf16(x[2], x[3]);
        pa[kl][2] = pack_bf16(x[4], x[5]);
        pa[kl][3] = pack_bf16(x[6], x[7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kl = 0; kl < 4; ++kl)
#pragma unroll
        for (int j = 0; j < HC; ++j)
          wgmma_rs_n16_tb(o[j], pa[kl], desc(ks + BLK + kl * 2 * (Hp * 16) + j * 256, Hp * 16, 128));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < HC; ++j) fence_regs(o[j]);
    }
    __syncthreads();  // every warpgroup is done with the stage before it is refilled
  }

  const int row = qt * QT + warp * 16 + (lane >> 2) + (t4 & 1) * 8;
  const long long off = (long long)b * p.ob + (long long)h * p.oh + (long long)row * p.on;
  if (p.out_kind == 0)
    store_rows<HC>(o, N, hd, row, reinterpret_cast<bf16*>(p.out) + off, 0.0f, t4);
  else if (p.out_kind == 1)
    store_rows<HC>(o, N, hd, row, reinterpret_cast<float*>(p.out) + off, 0.0f, t4);
  else
    store_rows<HC>(o, N, hd, row, reinterpret_cast<int8_t*>(p.out) + off,
                   FL == FL_EXP2P ? __fmul_rn((t4 & 1) ? l1 : l0, __fdiv_rn(1.0f, *p.out_scale))
                                  : __fdiv_rn(1.0f, *p.out_scale),
                   t4);
}

__device__ __forceinline__ void store_out(float* out, float o, float) { *out = o; }
__device__ __forceinline__ void store_out(int8_t* out, float o, float inv) {
  *out = quantize(o, inv);
}

// f32 inputs: one thread per logit and per output element, f32 FMAs, keys
// in blocks of KB through shared memory and two passes over them, as the
// bf16 key-block kernel: (1) the logits, each row's max and its sum,
// rescaled when the max grows; (2) the logits again, p = exp(s - m) * (1 / l)
// (f32, v's dtype), and each output's sum over the block's keys added to its
// running value in shared memory, key after key.
template <typename OutT>
__global__ void __launch_bounds__(AT) attention_f32_kernel(const AttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* pq = reinterpret_cast<const float*>(p.q);
  const float* pk = reinterpret_cast<const float*>(p.k);
  const float* pv = reinterpret_cast<const float*>(p.v);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N, hd = p.hd, ldk = hd + 1;

  float* Ks = reinterpret_cast<float*>(smem);  // KB x (hd + 1)
  float* Vs = Ks + round4(KB * ldk);           // KB x hd, 16-byte aligned
  float* Qs = Vs + KB * hd;                    // QT x hd, scaled
  float* Os = Qs + QT * hd;                    // QT x hd, the outputs' running sums
  float* S = Os + QT * hd;                     // QT x KB logits, then probabilities
  float* rm = S + QT * KB;                     // QT row maxima
  float* rl = rm + QT;                         // QT row sums, then their reciprocals

  const long long base = (long long)b * p.ib + (long long)h * p.ih;
  const int cpr = hd / 4;  // 16-byte chunks per row (hd % 8 == 0)
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
  for (int e = tid; e < QT * hd; e += AT) Os[e] = 0.0f;
  if (tid < QT) {
    rm[tid] = -INFINITY;
    rl[tid] = 0.0f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < N; k0 += KB) {
      const int nk = min(KB, N - k0);
      __syncthreads();  // the previous block is no longer read
      for (int c = tid; c < nk * cpr; c += AT) {
        const int r = c / cpr, cc = (c % cpr) * 4;
        const long long off = base + (long long)(k0 + r) * p.in + cc;
        const float4 kv = *reinterpret_cast<const float4*>(pk + off);
        float* kd = Ks + r * ldk + cc;
        kd[0] = kv.x, kd[1] = kv.y, kd[2] = kv.z, kd[3] = kv.w;
        if (pass) *reinterpret_cast<float4*>(Vs + r * hd + cc) =
            *reinterpret_cast<const float4*>(pv + off);
      }
      __syncthreads();
      // Logits S = Qs . Ks^T: neighbouring threads take neighbouring keys.
      for (int e = tid; e < QT * nk; e += AT) {
        const int r = e / nk, c = e % nk;
        const float* qr = Qs + r * hd;
        const float* kr = Ks + c * ldk;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        S[r * KB + c] = acc;
      }
      __syncthreads();
      for (int r = warp; r < QT; r += AT / 32) {  // a warp a row
        float* srow = S + r * KB;
        if (pass == 0) {
          float m = -INFINITY;
          for (int c = lane; c < nk; c += 32) m = fmaxf(m, srow[c]);
          const float mo = rm[r], mn = fmaxf(mo, warp_max(m));
          float s = 0.0f;
          for (int c = lane; c < nk; c += 32) s = __fadd_rn(s, expf(__fsub_rn(srow[c], mn)));
          s = warp_sum(s);
          if (lane == 0) {
            rl[r] = __fadd_rn(__fmul_rn(rl[r], expf(__fsub_rn(mo, mn))), s);
            rm[r] = mn;
          }
        } else {  // p stays f32 (v's dtype)
          const float m = rm[r], inv = rl[r];
          for (int c = lane; c < nk; c += 32) srow[c] = __fmul_rn(expf(__fsub_rn(srow[c], m)), inv);
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      for (int e = tid; e < QT * hd; e += AT) {  // O += P . Vs
        const int r = e / hd, c = e % hd;
        const float* pr = S + r * KB;
        float acc = Os[e];
        for (int k = 0; k < nk; ++k) acc = fmaf(pr[k], Vs[k * hd + c], acc);
        Os[e] = acc;
      }
    }
    __syncthreads();
    if (pass == 0 && tid < QT) rl[tid] = __fdiv_rn(1.0f, rl[tid]);
  }
  __syncthreads();

  const long long obase = (long long)b * p.ob + (long long)h * p.oh;
  OutT* out = reinterpret_cast<OutT*>(p.out);
  const float inv_out = p.out_scale ? __fdiv_rn(1.0f, *p.out_scale) : 0.0f;
  for (int e = tid; e < QT * hd; e += AT) {
    const int r = e / hd, c = e % hd;
    const int row = qt * QT + r;
    if (row < N) store_out(out + obase + (long long)row * p.on + c, Os[e], inv_out);
  }
}

typedef void (*Kernel)(const AttnArgs);

// One launch of ``kernel`` (threads a CTA, rows query rows a CTA) over the
// (query tile, head, crop) grid, after raising its shared-memory limit.
int launch(Kernel kernel, int threads, int rows, const AttnArgs& p, int elem, int B, int H,
           cudaStream_t st) {
  const int smem = smem_bytes(p.N, p.hd, elem);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + rows - 1) / rows, H, B);
  kernel<<<grid, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
