// Fused MANO forward kinematics + blendshapes + skinning, f32: kernel K9.
//
// Replaces the TPU kernel hamer_yolo_tpu/ops/mano_pallas.py:mano_lbs_fused
// (_mano_blend_skin_kernel, and the forward kinematics _fk that the TPU
// kernel leaves to XLA outside it). Per hand:
//   j_rest  = jr_t + jr_sd . betas          (jr_t = J_regressor @ v_template,
//                                            jr_sd = J_regressor . shapedirs)
//   rot_k   = rot_parent @ R_k,  joint_k = rot_parent @ (j_rest_k - j_rest_parent)
//             + joint_parent                (the 16-joint chain, root: R_0, j_rest_0)
//   A_flat  = [rot_k row-major | joint_k - rot_k @ j_rest_k]      (16 x 12)
//   v_posed = (v_template + shapedirs (2334 x nb) . betas)
//             + posedirs (2334 x 135) . (R_1..15 - I)
//   T       = weights (778 x 16) @ A_flat
//   out_x   = T0 x + T1 y + T2 z + T9   (out_y: T3..5, T10; out_z: T6..8, T11)
//
// Design: the grid is (vertex tiles of 32, hands), one launch for the whole
// function. Each CTA recomputes its hand's forward kinematics (16 3 x 3
// products, nothing beside the blend): 48 threads regress j_rest from the
// per-model constants jr_t and jr_sd (ops/mano_lbs.fk_constants, made once
// per model), then 16 threads walk the chain by depth level (each joint's
// depth from the parents array; MANO's five fingers are three levels deep
// below the root, five joints a level), and the CTA of tile 0 writes the
// joints. The hand's betas, pose features and A_flat stay in shared memory.
// Its 8 warps take the tile's 96 blendshape rows one row per warp at a
// time: the 135 posedirs of a row are contiguous, so the lanes read them
// coalesced, multiply by the pose features and reduce by shuffles (the same
// for the nb shapedirs, read with the model's own row stride, so no column
// slice is copied). Then one thread per vertex blends the 16 joint
// transforms and applies the affine.
//
// What bounds it on the H100: 16 hands are about 16 MFLOP against 1.6 MB of
// model arrays and output, under a microsecond either way, by bytes. The
// launch itself costs more than the work, so the design's point is that
// the wrapper makes exactly one launch: no kinematics, pose features or
// input views around it. posedirs (1.26 MB) is re-read by every hand, from
// L2 after the first.
//
// The affine and the sums around the two dot products use the _rn
// intrinsics, so no FMA contraction changes a rounding that the plain
// version does in two steps; inside the dot products and the 3 x 3
// products the order of the sums differs from any matmul's anyway, and
// they use FMAs.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int V = 778, J = 16, NPOSE = 135;
constexpr int VT = 32, LT = 256;  // vertices per CTA, threads per CTA
constexpr int MAX_NB = 64;

// c = a (3 x 3) @ b (3 x 3), row-major.
__device__ __forceinline__ void mat3(const float* a, const float* b, float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[i * 3 + j] = fmaf(a[i * 3 + 2], b[6 + j], fmaf(a[i * 3 + 1], b[3 + j], a[i * 3] * b[j]));
}

// a (3 x 3) @ v (3,), row i.
__device__ __forceinline__ float matvec3(const float* a, const float* v, int i) {
  return fmaf(a[i * 3 + 2], v[2], fmaf(a[i * 3 + 1], v[1], a[i * 3] * v[0]));
}

__global__ void __launch_bounds__(LT)
mano_lbs_kernel(const float* __restrict__ betas, const float* __restrict__ rotmats,
                const float* __restrict__ jr_t, const float* __restrict__ jr_sd,
                const int* __restrict__ parents, const float* __restrict__ v_template,
                const float* __restrict__ shapedirs, const float* __restrict__ posedirs,
                const float* __restrict__ weights, float* __restrict__ verts,
                float* __restrict__ joints, int nb, int ld_sd) {
  __shared__ float s_betas[MAX_NB];
  __shared__ float s_rm[J * 9];   // the hand's rotations
  __shared__ float s_pf[NPOSE];   // its pose features R_1..15 - I
  __shared__ float s_jr[J * 3];   // its rest joints
  __shared__ float s_rot[J * 9];  // the chain's rotations
  __shared__ float s_tr[J * 3];   // and joints
  __shared__ float s_a[J * 12];   // A_flat
  __shared__ float s_vp[VT * 3];
  const int hand = blockIdx.y, v0 = blockIdx.x * VT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < nb; i += LT) s_betas[i] = betas[hand * nb + i];
  for (int i = tid; i < J * 9; i += LT) s_rm[i] = rotmats[hand * J * 9 + i];
  __syncthreads();

  for (int i = tid; i < NPOSE; i += LT) {
    const int e = i % 9;  // element (r, c) of R_{1 + i / 9}, diagonal where e % 4 == 0
    s_pf[i] = __fsub_rn(s_rm[9 + i], e % 4 == 0 ? 1.0f : 0.0f);
  }
  if (tid < J * 3) {
    float s = 0.0f;
    for (int k = 0; k < nb; ++k) s = fmaf(jr_sd[tid * nb + k], s_betas[k], s);
    s_jr[tid] = __fadd_rn(jr_t[tid], s);
  }
  int depth = 0;
  if (tid < J)
    for (int k = tid; parents[k] >= 0; k = parents[k]) ++depth;
  __syncthreads();
  if (tid < 9) s_rot[tid] = s_rm[tid];
  if (tid < 3) s_tr[tid] = s_jr[tid];
  // the chain, one depth level at a time (a barrier between levels)
  for (int level = 1; __syncthreads_or(tid < J && depth >= level); ++level) {
    if (tid < J && depth == level) {
      const int p = parents[tid];
      mat3(s_rot + p * 9, s_rm + tid * 9, s_rot + tid * 9);
      const float t_rel[3] = {__fsub_rn(s_jr[tid * 3], s_jr[p * 3]),
                              __fsub_rn(s_jr[tid * 3 + 1], s_jr[p * 3 + 1]),
                              __fsub_rn(s_jr[tid * 3 + 2], s_jr[p * 3 + 2])};
#pragma unroll
      for (int i = 0; i < 3; ++i)
        s_tr[tid * 3 + i] = __fadd_rn(matvec3(s_rot + p * 9, t_rel, i), s_tr[p * 3 + i]);
    }
  }
  if (tid < J) {
#pragma unroll
    for (int i = 0; i < 9; ++i) s_a[tid * 12 + i] = s_rot[tid * 9 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s_a[tid * 12 + 9 + i] =
          __fsub_rn(s_tr[tid * 3 + i], matvec3(s_rot + tid * 9, s_jr + tid * 3, i));
      if (blockIdx.x == 0) joints[(hand * J + tid) * 3 + i] = s_tr[tid * 3 + i];
    }
  }
  __syncthreads();

  const int rows = min(VT, V - v0) * 3;
  for (int r = warp; r < rows; r += LT / 32) {
    const int row = v0 * 3 + r;
    float sd = 0.0f, pd = 0.0f;
    for (int k = lane; k < nb; k += 32) sd = fmaf(shapedirs[(size_t)row * ld_sd + k], s_betas[k], sd);
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

// betas (S, nb), rotmats (S, 16, 3, 3), jr_t (16, 3), jr_sd (16, 3, nb),
// parents (16,) int32 (parents[0] = -1, parents[k] < k), v_template (778,
// 3), shapedirs (2334, ld_sd) of which the first nb columns are read,
// posedirs (2334, 135), weights (778, 16) -> verts (S, 778, 3), joints (S,
// 16, 3); all contiguous f32 on the device but parents, nb <= 64.
extern "C" int hyt_mano_lbs(const void* betas, const void* rotmats, const void* jr_t,
                            const void* jr_sd, const void* parents, const void* v_template,
                            const void* shapedirs, const void* posedirs, const void* weights,
                            void* verts, void* joints, int S, int nb, int ld_sd, void* stream) {
  if (S <= 0 || S > 65535 || nb <= 0 || nb > MAX_NB || ld_sd < nb)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + VT - 1) / VT, S);
  mano_lbs_kernel<<<grid, LT, 0, (cudaStream_t)stream>>>(
      (const float*)betas, (const float*)rotmats, (const float*)jr_t, (const float*)jr_sd,
      (const int*)parents, (const float*)v_template, (const float*)shapedirs,
      (const float*)posedirs, (const float*)weights, (float*)verts, (float*)joints, nb, ld_sd);
  return (int)cudaGetLastError();
}
