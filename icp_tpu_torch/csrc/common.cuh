// Shared device helpers of the icp_tpu_torch kernels.
//
// Every value that feeds an argmin is computed with explicit round-to-nearest
// intrinsics (__fmul_rn / __fadd_rn / __fsub_rn), which the compiler never
// contracts into an FMA: the kernels then round exactly where the plain
// PyTorch twins (icp_tpu_torch/kernels/fused_step.py, lane_dot and dot3) do,
// one rounding per multiply and per add in lane order, and kernel and twin
// make bit-identical nearest-neighbour decisions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace icp {

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// x rounded to bfloat16 (round to nearest even) and back to float32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 split x = hi + lo as in dot3: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
  hi = bf16_round(x);
  lo = bf16_round(__fsub_rn(x, hi));
}

// sum_k a[k] * b[k * stride] in lane order, one rounding per operation.
template <int K>
__device__ __forceinline__ float lane_dot(const float* a, const float* b,
                                          int stride) {
  float acc = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(a[k], b[k * stride]));
  return acc;
}

// bf16x3 score contraction (hi.hi + hi.lo) + lo.hi over 8 lanes.
__device__ __forceinline__ float dot3_8(const float* a_hi, const float* a_lo,
                                        const float* b_hi, const float* b_lo,
                                        int stride) {
  const float hh = lane_dot<8>(a_hi, b_hi, stride);
  const float hl = lane_dot<8>(a_hi, b_lo, stride);
  const float lh = lane_dot<8>(a_lo, b_hi, stride);
  return __fadd_rn(__fadd_rn(hh, hl), lh);
}

}  // namespace icp
