// Fused MANO blendshapes + skinning, f32: kernel K9.
//
// Replaces the TPU kernel hamer_yolo_tpu/ops/mano_pallas.py:mano_lbs_fused
// (_mano_blend_skin_kernel). Per hand:
//   v_posed = (v_template + shapedirs (2334 x nb) . betas)
//             + posedirs (2334 x 135) . pose_feat
//   T       = weights (778 x 16) @ A_flat (16 x 12)      [R row-major | t]
//   out_x   = T0 x + T1 y + T2 z + T9   (out_y: T3..5, T10; out_z: T6..8, T11)
// with the 16-joint forward kinematics that makes A_flat left outside, as the
// TPU kernel leaves it.
//
// Design: the TPU kernel walks a grid of one hand per step over whole-array
// blocks. Here the grid is (vertex tiles of 32, hands). A CTA keeps the
// hand's betas, pose_feat and A_flat in shared memory. Its 8 warps take the
// tile's 96 blendshape rows one row per warp at a time: the 135 posedirs of
// a row are contiguous, so the lanes read them coalesced, multiply by
// pose_feat and reduce by shuffles (the same for the nb shapedirs). Then one
// thread per vertex blends the 16 joint transforms and applies the affine.
//
// What bounds it on the H100: 16 hands are about 16 MFLOP against 1.6 MB of
// model arrays and output, under a microsecond either way, by bytes. The
// launch itself costs more than the work, and the 15-step forward kinematics
// outside (small einsums, one launch each) more than the kernel. posedirs
// (1.26 MB) is re-read by every hand, from L2 after the first.
//
// The affine and the sums around the two dot products use the _rn
// intrinsics, so no FMA contraction changes a rounding that the plain
// version does in two steps; inside the dot products the order of the sum
// differs from any matmul's anyway, and they use FMAs.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int V = 778, J = 16, NPOSE = 135;
constexpr int VT = 32, LT = 256;  // vertices per CTA, threads per CTA
constexpr int MAX_NB = 64;

__global__ void __launch_bounds__(LT)
mano_blend_skin_kernel(const float* __restrict__ betas, const float* __restrict__ pose_feat,
                       const float* __restrict__ a_flat, const float* __restrict__ v_template,
                       const float* __restrict__ shapedirs, const float* __restrict__ posedirs,
                       const float* __restrict__ weights, float* __restrict__ verts, int nb) {
  __shared__ float s_betas[MAX_NB];
  __shared__ float s_pf[NPOSE];
  __shared__ float s_a[J * 12];
  __shared__ float s_vp[VT * 3];
  const int hand = blockIdx.y, v0 = blockIdx.x * VT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < nb; i += LT) s_betas[i] = betas[hand * nb + i];
  for (int i = tid; i < NPOSE; i += LT) s_pf[i] = pose_feat[hand * NPOSE + i];
  for (int i = tid; i < J * 12; i += LT) s_a[i] = a_flat[hand * J * 12 + i];
  __syncthreads();

  const int rows = min(VT, V - v0) * 3;
  for (int r = warp; r < rows; r += LT / 32) {
    const int row = v0 * 3 + r;
    float sd = 0.0f, pd = 0.0f;
    for (int k = lane; k < nb; k += 32) sd = fmaf(shapedirs[(size_t)row * nb + k], s_betas[k], sd);
    for (int k = lane; k < NPOSE; k += 32) pd = fmaf(posedirs[(size_t)row * NPOSE + k], s_pf[k], pd);
    sd = warp_sum(sd);
    pd = warp_sum(pd);
    if (lane == 0) s_vp[r] = __fadd_rn(__fadd_rn(v_template[row], sd), pd);
  }
  __syncthreads();

  if (tid < VT && v0 + tid < V) {
    const int v = v0 + tid;
    float T[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) T[j] = 0.0f;
    for (int k = 0; k < J; ++k) {
      const float w = weights[v * J + k];
#pragma unroll
      for (int j = 0; j < 12; ++j) T[j] = fmaf(w, s_a[k * 12 + j], T[j]);
    }
    const float x = s_vp[tid * 3], y = s_vp[tid * 3 + 1], z = s_vp[tid * 3 + 2];
    float* o = verts + ((size_t)hand * V + v) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* t = T + 3 * c;
      o[c] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t[0], x), __fmul_rn(t[1], y)),
                                 __fmul_rn(t[2], z)), T[9 + c]);
    }
  }
}

}  // namespace

// betas (S, nb), pose_feat (S, 135), a_flat (S, 16, 12), v_template (778, 3),
// shapedirs (2334, nb), posedirs (2334, 135), weights (778, 16) -> verts
// (S, 778, 3); all contiguous f32 on the device, nb <= 64.
extern "C" int hyt_mano_lbs(const void* betas, const void* pose_feat, const void* a_flat,
                            const void* v_template, const void* shapedirs, const void* posedirs,
                            const void* weights, void* verts, int S, int nb, void* stream) {
  if (S <= 0 || nb <= 0 || nb > MAX_NB) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + VT - 1) / VT, S);
  mano_blend_skin_kernel<<<grid, LT, 0, (cudaStream_t)stream>>>(
      (const float*)betas, (const float*)pose_feat, (const float*)a_flat,
      (const float*)v_template, (const float*)shapedirs, (const float*)posedirs,
      (const float*)weights, (float*)verts, nb);
  return (int)cudaGetLastError();
}
