// Shared device helpers of the icp_tpu_torch kernels.
//
// Every value that feeds an argmin is computed with explicit round-to-nearest
// intrinsics (__fmul_rn / __fadd_rn / __fsub_rn), which the compiler never
// contracts into an FMA: the kernels then round exactly where the plain
// PyTorch twins (icp_tpu_torch/kernels/fused_step.py, lane_dot and dot3) do,
// one rounding per multiply and per add in lane order, and kernel and twin
// make bit-identical nearest-neighbour decisions. dot3_8_fma reaches the
// same bits with explicit __fmaf_rn where every product is exact.
//
// prep_query is the query preparation of every per-bin search (K3, K4, K7),
// which bin_search_phase.cuh holds, on live pairs only. They score with
// dot3_8_fma and score_fma, bit for bit the JAX package's _score_core /
// _search_core (icp_tpu/kernels/fused_step.py:449-517).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace icp {

// Launch limits (launch_limits.cu). An entry point whose shapes pass a
// limit of the card launches nothing and returns kLaunchLimit, which no
// CUDA status equals, after launch_limit() has left the reason, with the
// limit and the shape, for icp_launch_limit_message(); the loader raises it
// as a ValueError.
constexpr int kLaunchLimit = -1;
constexpr int kMaxGridY = 65535;  // a grid's second dimension
int launch_limit(const char* fmt, ...);
// The current device's opt-in dynamic shared memory a block and its SM
// count, read once per device.
int smem_optin();
int sm_count();

// Robust M-estimator kinds, as ``robust_kind`` of the wrappers passes them.
enum Robust : int { kNone = 0, kHuber = 1, kTukey = 2, kTrimmed = 3 };

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

// The bf16x3 score contraction (hi.hi + hi.lo) + lo.hi over 8 lanes, the
// twins' dot3 (fused_step.py), with fused multiply-adds.
//
// Every product of a bf16x3 score is a bf16 value times a bf16 value: two
// 8-bit significands multiply to at most 16 bits, so the float32 product is
// exact (the scores' operands stay far from float32's under- and overflow).
// __fmaf_rn(a, b, acc) rounds a * b + acc once, and so does
// __fadd_rn(__fmul_rn(a, b), acc) when __fmul_rn(a, b) is exact: each lane
// sum is one __fmul_rn and seven __fmaf_rn in lane order, equal to
// lane_dot<8>, and the three sums join in dot3's order
// (tests/test_torch_exact_fma.py). An explicit __fmaf_rn leaves nothing to
// the compiler's contraction.
__device__ __forceinline__ float dot3_8_fma(const float a_hi[8], const float a_lo[8],
                                            const float b_hi[8], const float b_lo[8]) {
  float hh = __fmul_rn(a_hi[0], b_hi[0]);
  float hl = __fmul_rn(a_hi[0], b_lo[0]);
  float lh = __fmul_rn(a_lo[0], b_hi[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    hh = __fmaf_rn(a_hi[k], b_hi[k], hh);
    hl = __fmaf_rn(a_hi[k], b_lo[k], hl);
    lh = __fmaf_rn(a_lo[k], b_hi[k], lh);
  }
  return __fadd_rn(__fadd_rn(hh, hl), lh);
}

// sq - 2 * cross with one rounding: 2 * cross is exact, so this equals
// __fsub_rn(sq, __fmul_rn(2.0f, cross)) bit for bit.
__device__ __forceinline__ float score_fma(float sq, float cross) {
  return __fmaf_rn(-2.0f, cross, sq);
}

// One raw query row p prepared for a bin's search: qc = p @ G + off
// (g: the (8, 8) similarity G row-major; off = b_row - rep), its weighted
// qw = qc * w8 split into bf16 halves, sq_q = |qc|^2_w, and
// valid = qvalid * (|p_xyz|_1 > 0).
__device__ __forceinline__ void prep_query(const float p[8], float qvalid,
                                           const float* g, const float* off,
                                           const float w8[8], float qc[8],
                                           float hi[8], float lo[8],
                                           float& sq_q, float& valid) {
  float qw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qc[j] = __fadd_rn(lane_dot<8>(p, g + j, 8), off[j]);
    qw[j] = __fmul_rn(qc[j], w8[j]);
    bf16_split(qw[j], hi[j], lo[j]);
  }
  sq_q = lane_dot<8>(qw, qc, 1);
  const float vo = (fabsf(p[0]) + fabsf(p[1]) + fabsf(p[2])) > 0.0f ? 1.0f : 0.0f;
  valid = __fmul_rn(qvalid, vo);
}

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

// Blended squared NN distance max(best + |qc|^2_w, 0).
__device__ __forceinline__ float match_d2(float best, float sq_q) {
  return fmaxf(__fadd_rn(best, sq_q), 0.0f);
}

// IRLS factor of ops/moments.py robust_factor on d2 >= 0.
__device__ __forceinline__ float robust_factor(float d2, int kind, float delta) {
  const float delta2 = __fmul_rn(delta, delta);
  switch (kind) {
    case kHuber:
      return fminf(1.0f, __fmul_rn(delta, rsqrtf(fmaxf(d2, 1e-12f))));
    case kTukey: {
      const float z = fmaxf(__fsub_rn(1.0f, __fdiv_rn(d2, delta2)), 0.0f);
      return __fmul_rn(z, z);
    }
    case kTrimmed:
      return d2 <= delta2 ? 1.0f : 0.0f;
    default:
      return 1.0f;
  }
}

// The composed pair weight of _search_core: validity (slot occupied, original
// point non-zero, bin non-empty) x [reference 100 / (100 + d2)] x [robust].
__device__ __forceinline__ float match_weight(float best, float sq_q, float valid,
                                              int weighted, int robust, float delta) {
  float w = __fmul_rn(valid, is_finite(best) ? 1.0f : 0.0f);
  if (weighted || robust != kNone) {
    const float d2 = match_d2(best, sq_q);
    if (weighted) w = __fmul_rn(w, __fdiv_rn(100.0f, __fadd_rn(100.0f, d2)));
    if (robust != kNone) w = __fmul_rn(w, robust_factor(d2, robust, delta));
  }
  return w;
}

}  // namespace icp
