// Device helpers shared by the port's kernels (attn_block.cu, int8_gemm.cu,
// short_attention.cu). Sums use the _rn intrinsics so no FMA contraction
// changes a rounding that the plain versions do in two steps.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

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

// Eight bf16 values as one 16-byte vector.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// clip(rint(v * inv), +-127): int8 quantization by a reciprocal scale,
// rounding half to even.
__device__ __forceinline__ int8_t quantize(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

}  // namespace
