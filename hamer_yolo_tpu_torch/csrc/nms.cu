// Greedy NMS keep mask over score-sorted candidates, one CTA per image.
//
// Replaces the TPU kernel hamer_yolo_tpu/ops/nms_pallas.py:greedy_nms_keep
// (_nms_kernel). Same contract: boxes (B, K, 4) f32 xyxy, score-sorted and
// class-shifted; active (B, K) f32 {0, 1}; thr scalar -> keep (B, K) f32.
//
// What bounds it on the H100: not bytes (B*K*16 bytes in, B*K*4 out) and not
// FLOPs (K^2 IoUs), but the K-step greedy scan, which is sequential by
// definition. The design keeps the scan cheap: the K x K suppression matrix
// is built once as a bitmask in shared memory (512 x 16 uint32 = 32 KB) by
// all 256 threads, and the scan runs in ONE warp over a 16-word alive mask,
// one shuffle per step, so no step touches device memory or a block barrier.
// One CTA per image; B images fill B SMs (B is the frame batch).
//
// Numerics must match the plain version bit for bit, because a candidate
// whose IoU sits at the threshold is kept by one version and dropped by the
// other otherwise. IoU is computed exactly as geometry/boxes.box_iou does,
// inter / max(area_i + area_j - inter, 1e-12) tested `> thr` in f32, with
// the _rn intrinsics so that nvcc contracts nothing into an FMA (the file is
// also built with --fmad=false). No fast math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 512;
constexpr int kWords = kMaxK / 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes, const float* __restrict__ active,
                float thr, float* __restrict__ keep, int K) {
  __shared__ float4 sbox[kMaxK];
  __shared__ float sarea[kMaxK];
  __shared__ uint32_t smask[kMaxK][kWords];
  __shared__ uint32_t sbits[kWords];  // active bits, later the keep bits

  const int b = blockIdx.x;
  const int W = (K + 31) / 32;
  const float4* bx = boxes + (size_t)b * K;
  const float* act = active + (size_t)b * K;

  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float4 v = bx[i];
    sbox[i] = v;
    sarea[i] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
  }
  if (threadIdx.x < W) {
    uint32_t bits = 0;
    for (int j = 0; j < 32; ++j) {
      const int idx = threadIdx.x * 32 + j;
      if (idx < K && act[idx] > 0.5f) bits |= 1u << j;
    }
    sbits[threadIdx.x] = bits;
  }
  __syncthreads();

  // Suppression bitmask: row i, word w holds (iou(i, j) > thr) for the 32
  // columns j of that word, diagonal cleared, bits past K left 0.
  for (int t = threadIdx.x; t < K * W; t += blockDim.x) {
    const int i = t / W;
    const int w = t - i * W;
    const float4 a = sbox[i];
    const float area_a = sarea[i];
    uint32_t bits = 0;
    for (int jj = 0; jj < 32; ++jj) {
      const int j = w * 32 + jj;
      if (j >= K) break;
      if (j == i) continue;
      const float4 c = sbox[j];
      const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area_a, sarea[j]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
      if (iou > thr) bits |= 1u << jj;
    }
    smask[i][w] = bits;
  }
  __syncthreads();

  // Greedy scan in one warp: lane l owns word l of the alive mask.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const uint32_t act_w = lane < W ? sbits[lane] : 0u;
    uint32_t alive = lane < W ? 0xffffffffu : 0u;
    for (int i = 0; i < K; ++i) {
      const uint32_t owner = __shfl_sync(0xffffffffu, alive & act_w, i >> 5);
      if ((owner >> (i & 31)) & 1u) {  // warp-uniform branch
        if (lane < W) alive &= ~smask[i][lane];
      }
    }
    if (lane < W) sbits[lane] = alive & act_w;
  }
  __syncthreads();

  float* out = keep + (size_t)b * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    out[j] = ((sbits[j >> 5] >> (j & 31)) & 1u) ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int hyt_nms_keep(const void* boxes, const void* active, float thr,
                            void* keep, int B, int K, void* stream) {
  if (K <= 0 || K > kMaxK || B <= 0) return (int)cudaErrorInvalidValue;
  nms_keep_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)active, thr, (float*)keep, K);
  return (int)cudaGetLastError();
}
