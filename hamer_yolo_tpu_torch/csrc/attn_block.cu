// Exact-bf16 fused LN + QKV GEMM + softmax attention block (pre-proj):
// kernel K2.
//
// Replaces the TPU kernel
// hamer_yolo_tpu/ops/attention_pallas.py:fused_bf16_attn_block
// (_attn_block_bf16_kernel): f32 LayerNorm (eps 1e-6) -> bf16 (M, K) x (K, 3D)
// QKV GEMM with f32 accumulate + f32 bias -> bf16 -> per head
// softmax(bf16(q * scale) k^T) v with f32 accumulate -> (B, N, D) in the
// tokens' dtype (bf16 or f32, as the TPU kernel's out_shape is tok.dtype).
// ViT-H: tokens (B, 192, 1280), w (1280, 3840), 16 heads of width 80.
//
// What bounds it on the H100: at M = B N = 768-12288 rows the QKV GEMM is
// 7.5-121 GFLOP against 12-73 MB of tokens, weight and qkv, so the tensor
// cores bound it (989 TFLOP/s bf16); the attention (csrc/short_attention.cu)
// is bound by the qkv round trip through device memory.
//
// Launches (ops/attn_block.py makes them):
//  (a) ln_rows_kernel: one warp a row: the LN statistics in two passes as the
//      plain version computes them (the mean, then the mean of squared
//      deviations), then the row's LN output
//      x^ = bf16(((x - mu) * rstd) * gamma + beta), once a row, to device
//      memory (M x K bf16);
//  (b) qkv_gemm_kernel, designed for Hopper (sm_90a): a persistent CTA per SM
//      walks 128 x 256 output tiles (n fastest, so the CTAs at work share x^'s
//      rows and the weight in L2); K goes in 64-element (128-byte) steps
//      through a 3-stage ring of shared memory that a producer warp fills with
//      TMA (cp.async.bulk.tensor on mbarriers, the 128-byte swizzle); two
//      warpgroups of 64 rows run wgmma m64n256k16 bf16 x bf16 -> f32 from
//      shared-memory descriptors and release each stage once its products
//      have retired. After a tile's last stage each warpgroup adds the f32
//      bias, rounds to bf16 into a swizzled staging tile, and one thread
//      stores it by TMA while the warpgroup runs the next tile's products.
//      The weight stays in JAX's (K, 3D) row-major layout: 16-bit wgmma reads
//      B transposed (MN-major) through the instruction's transpose bit, from
//      64 x 64 TMA boxes (four to a 256-wide tile); ops/attn_block.py makes
//      the bf16 copy and its TMA map once per weight tensor;
//  (c) the attention of csrc/short_attention.cu (K3 and K7 launch it too) on
//      strided views of the qkv buffer, its output in the tokens' dtype.
// Measured against this form on an H100 (PERF.md): a transform
// warpgroup inside the GEMM that normalises TMA-fed raw token tiles into the
// A stages (no x^ round trip) ran the GEMM at half this speed, 128 x 128
// tiles and an epilogue storing straight from registers slower too.
//
// Rounding points follow the TPU kernel exactly: LN in f32 then bf16; qkv in
// f32 + bias then bf16 (the attention's own: csrc/short_attention.cu).
// Elementwise steps use the _rn intrinsics so no FMA contraction changes a
// rounding that the plain version does in two steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ (a) LN rows
constexpr int RW = 8;  // rows (warps) of a block

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

// One warp a row: the row's mean, then the mean of its squared deviations,
// rstd = rsqrtf(var + 1e-6), then the row's LN output in bf16:
// ((x - mu) * rstd) * gamma + beta, each step rounded. rsqrtf, as the kernel
// this replaced: against the twin on the card it flips fewer bf16 roundings
// of x^ than the correctly rounded __frsqrt_rn (PERF.md).
template <typename TokT>
__global__ void __launch_bounds__(RW * 32)
ln_rows_kernel(const TokT* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, int M, int K, bf16* __restrict__ xhat) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * RW + (threadIdx.x >> 5);
  if (row >= M) return;
  const TokT* xr = x + (size_t)row * K;
  float s = 0.0f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = __fadd_rn(s, v[i]);
  }
  const float mu = __fdiv_rn(warp_sum(s), (float)K);
  float q = 0.0f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __fsub_rn(v[i], mu);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)K), 1e-6f));
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
    Pack8 o;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o.h[i] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), rstd), gamma[k + i]), beta[k + i]));
    *reinterpret_cast<uint4*>(xhat + (size_t)row * K + k) = o.u;
  }
}

// ------------------------------------------------------------ (b) QKV GEMM
constexpr int BM = 128;  // rows of a tile: two warpgroups of 64
constexpr int BN = 256;  // columns of a tile
constexpr int BK = 64;   // K elements of a stage: one 128-byte swizzle row of bf16
constexpr int BOX = 64;  // rows and columns of a swizzled bf16 TMA box (128 bytes wide)
constexpr int THREADS = 256 + 32;  // two MMA warpgroups and the producer warp

// Shared memory of a CTA, from a 1024-byte aligned base: STAGES stages of
// [A: BM x BK bf16 (two 64-row boxes) | B: BK x BN bf16 (four 64-column
// boxes)], a staging tile of 64 x BN bf16 (four boxes) for each MMA
// warpgroup's outputs, all under the 128-byte swizzle; then two mbarriers a
// stage. 208 KB: one CTA an SM.
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
constexpr int STAGING_WG = 64 * BN * 2;
constexpr int STAGES = 3;
constexpr int STAGING = STAGES * STAGE_BYTES;
constexpr int BARS = STAGING + 2 * STAGING_WG;
constexpr int SMEM = BARS + 8 * 2 * STAGES + 1024;  // + room to align
// Diagnostic builds only (chip_gemm.py --k2 --variant, outputs wrong): 1 leaves
// out the epilogue, 2 the producer's TMA copies.
#ifndef HYT_K2_DIAG
#define HYT_K2_DIAG 0
#endif

// The shared-memory descriptor of an MN-major (transposed) B operand under
// the 128-byte swizzle, as TMA writes a row-major (K, N) weight in boxes of
// 64 K rows x 64 columns: in a box, K rows of 128 bytes in 8-row atoms 1024
// bytes apart (the stride byte offset); boxes 8192 bytes apart along N (the
// leading byte offset); layout type 1. A k16 step is two atoms, 2048 bytes.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(BK * BOX * 2 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 f32) += A (64 x 16 bf16, K-major) . B (16 x 256 bf16,
// MN-major): wgmma from shared memory, B read transposed.
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fence, commit and wait around them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// qkv (M, N) = bf16(x^ (M, K) @ w (K, N) + bias): the maps of x^ (64 x 64
// boxes), of w (64 x 64) and of qkv (64 x 64), all under the 128-byte swizzle.
__global__ void __launch_bounds__(THREADS, 1)
    qkv_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap, const float* __restrict__ bias,
                    int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t k2_smem_raw[];
  uint8_t* smem = k2_smem_raw + ((1024 - (smem_u32(k2_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS);  // the stage's copies landed
  uint64_t* empty = full + STAGES;  // both MMA warpgroups are done with it
  const int tid = threadIdx.x;
  const int nt = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * nt;
  const int KT = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2);  // one arrival per MMA warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {
      int it = 0;  // ring uses so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / nt * BM, n0 = tile % nt * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(smem_u32(empty + s), ((it / STAGES) & 1) ^ 1);
          const uint32_t bar = smem_u32(full + s);
          mbar_arrive_expect_tx(bar, HYT_K2_DIAG == 2 ? 0 : STAGE_BYTES);
          if (HYT_K2_DIAG == 2) continue;
          const uint32_t a = smem_u32(smem + s * STAGE_BYTES), b = a + A_BYTES;
#pragma unroll
          for (int r = 0; r < BM; r += BOX) tma_load(a + r * 128, &amap, kt * BK, m0 + r, bar);
#pragma unroll
          for (int j = 0; j < BN / BOX; ++j)
            tma_load(b + j * BK * BOX * 2, &wmap, n0 + j * BOX, kt * BK, bar);
        }
      }
    }
    return;
  }

  // the MMA warpgroups: 64 rows of the tile each
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  uint8_t* stg = smem + STAGING + wg * STAGING_WG;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / nt * BM, n0 = tile % nt * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(full + s), (it / STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * STAGE_BYTES);
      const uint64_t da = sw128_desc(a + wg * 64 * 128), db = sw128_mn_desc(a + A_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_bf16(acc, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && t == 0) mbar_arrive(smem_u32(empty + (it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (t == 0) mbar_arrive(smem_u32(empty + (it - 1) % STAGES));  // the tile's last stage
    if (HYT_K2_DIAG == 1) continue;
    // f32 + bias -> bf16 into this warpgroup's staging tile, from the
    // accumulator layout (n8 block j, rows g and g + 8 of the warp's 16,
    // columns 2 q and 2 q + 1): column c of row r of a 64-column box at chunk
    // (c / 8) ^ (r % 8) of its 128-byte row, as the store's map swizzles it,
    // so a warp's 4-byte writes fall in 32 different banks. Then one thread
    // stores the tile by TMA, which clips it at M and N, and the warpgroup
    // goes on to the next tile's products while the store runs.
    if (t == 0) bulk_wait<0, true>();  // the last tile's store has read the staging tile
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + 2 * q, col = n0 + c;
      const float2 bb = col < N ? *reinterpret_cast<const float2*>(bias + col)
                                : make_float2(0.0f, 0.0f);  // N % 8 == 0: pairs in or out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + 8 * h + g;
        *reinterpret_cast<__nv_bfloat162*>(stg + (c / BOX) * (64 * 128) + r * 128 +
                                           ((((c % BOX) >> 3) ^ (r & 7)) << 4) + (c % 8) * 2) =
            __floats2bfloat162_rn(__fadd_rn(acc[4 * j + 2 * h], bb.x),
                                  __fadd_rn(acc[4 * j + 2 * h + 1], bb.y));
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < BN / BOX; ++b)
        tma_store(&omap, smem_u32(stg + b * 64 * 128), n0 + b * BOX, m0 + wg * 64);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait<0, false>();  // the stores are done before the CTA's memory goes
}

// The map of a row-major (rows, cols) bf16 matrix in 64 x 64 boxes under the
// 128-byte swizzle, as every operand of qkv_gemm_kernel is read or written.
int bf16_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, BOX, BOX,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// The TMA map of the bf16 (K, N) row-major weight at w, written to map (128
// bytes of host memory). The wrapper makes it once per weight, beside the
// weight's bf16 copy, and hands it to every hyt_ln_qkv on that weight.
// K % 8 == 0, N % 8 == 0, w 16-byte aligned.
extern "C" int hyt_k2_weight_map(const void* w, int K, int N, void* map) {
  if (K <= 0 || N <= 0 || K % 8 || N % 8 || (reinterpret_cast<uintptr_t>(w) & 15) || !map)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const int rc = bf16_map(&m, w, K, N);
  if (rc == 0) memcpy(map, &m, sizeof m);
  return rc;
}

// qkv (M, N) bf16 = bf16(bf16(LN(tok)) @ w + bias): tok (M, K) f32 with
// tok_f32, else bf16; w the bf16 (K, N) weight whose map hyt_k2_weight_map
// wrote to wmap; bias (N,), gamma and beta (K,) f32; xhat: (M, K) bf16
// scratch for the LN output. K % 8 == 0, N % 8 == 0; every pointer 16-byte
// aligned.
extern "C" int hyt_ln_qkv(const void* tok, int tok_f32, const void* wmap, const void* bias,
                          const void* gamma, const void* beta, void* xhat, void* qkv, int M,
                          int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || !wmap)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(tok) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(beta) |
       reinterpret_cast<uintptr_t>(xhat) | reinterpret_cast<uintptr_t>(qkv)) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 rows((M + RW - 1) / RW);
  const float *g = (const float*)gamma, *b = (const float*)beta;
  if (tok_f32)
    ln_rows_kernel<float><<<rows, RW * 32, 0, st>>>((const float*)tok, g, b, M, K, (bf16*)xhat);
  else
    ln_rows_kernel<bf16><<<rows, RW * 32, 0, st>>>((const bf16*)tok, g, b, M, K, (bf16*)xhat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The maps of x-hat and qkv are encoded from their addresses on every call
  // and passed by value: a CUDA graph that captures these launches
  // (pipeline/captured.py) keeps the maps of the capture, which is right only
  // because a replay uses the same addresses, those of the graph's pool.
  CUtensorMap amap, wm, omap;
  memcpy(&wm, wmap, sizeof wm);
  int rc = bf16_map(&amap, xhat, M, K);
  if (rc == 0) rc = bf16_map(&omap, qkv, M, N);
  if (rc) return rc;
  static bool smem_set[MAX_DEVICES] = {};  // the shared-memory limit raised on the device
  int dev = 0, sms = 0;
  if ((rc = current_sms(&dev, &sms))) return rc;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(qkv_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  qkv_gemm_kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM, st>>>(amap, wm, omap,
                                                                     (const float*)bias, M, N, K);
  return (int)cudaGetLastError();
}
