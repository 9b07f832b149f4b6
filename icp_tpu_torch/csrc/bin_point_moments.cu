// K3: per-bin nearest-neighbour search + weighting + 8x8 moment reduction.
//
// Replaces bin_point_moments_pallas (icp_tpu/kernels/fused_step.py:564),
// whose body is _score_core / _search_core / _moment_math (:449-547). For
// each bin b and each query slot i of its grouped table:
//   qc   = p @ G + (b_row - rep_b)            transformed, rep-centered query
//   s_c  = sq_b[b, c] - 2 dot3(qc * w8, bins_c[b, c])    (+inf on bad slots)
//   c*   = first argmin_c s_c,   d2 = max(s_c* + |qc|^2_w, 0)
//   w    = qvalid * (|p_xyz|_1 > 0) * isfinite(s_c*) * [100 / (100 + d2)]
//          * [robust_factor(d2, delta)]
//   u    = [qc_xyz, 1, bins_c[b, c*]_xyz, 1]
//   P_b  = sum_i w u u^T                                      (8 x 8)
//
// What bounds it: the FP32 instruction rate of the search, ~30
// instructions per (query, slot) pair (common.cuh's dot3_8_fma, the score's
// FFMA, compare and select), over the pairs the data holds: the valid query
// slots times the live slots of their bin. The inputs are a few MB.
//
// Design: one block of 256 threads per bin. Shared memory is bounded
// (74 KB at most) whatever the capacities: the block walks the query slots
// in tiles of up to 256 and the bin in tiles of up to 512 slots. At the
// main path's shapes (cq <= 256, cb <= 512) each is one tile and the bin is
// staged once.
// - The search is bin_search_phase.cuh's, shared with K7: live pairs only
//   (the bin cut at its last slot that is not +inf or NaN, the qvalid != 0
//   query slots kept by an order-keeping ballot), query tiles of up to 256
//   and bin tiles of up to 512 slots, (chunk of >= 16 slots, query) items
//   over all 256 threads, merged in slot order: the first minimum.
// - The reduction holds no 8x8 accumulator: each kept query writes w and u
//   to shared memory, and each warp sums some of the 36 distinct entries of
//   the symmetric P over the kept queries, lane l taking every query whose
//   rank among the bin's kept queries is l mod 32, in rank order across the
//   query tiles; then a fixed shuffle tree, mirrored into both triangles. P
//   repeats bitwise from run to run.
// - The robust scale delta is read on the device (scal[1]), as an adaptive
//   delta is computed there.
#include "bin_search_phase.cuh"

namespace {

using icp::live::kPairJ;
using icp::live::kPairL;
using icp::live::kThreads;
using icp::live::kWarps;
constexpr int kRow = 9;  // per kept query: u[0..7], w
constexpr int kEntries = (36 + kWarps - 1) / kWarps;  // P entries per warp

// Two blocks per SM: at most 128 registers a thread.
__global__ void __launch_bounds__(kThreads, 2)
bin_point_moments_kernel(const float* __restrict__ mg,
                         const float* __restrict__ qvalid,
                         const float* __restrict__ reps,
                         const float* __restrict__ bins_c,
                         const float* __restrict__ sq_b,
                         const float* __restrict__ G,
                         const float* __restrict__ b_row,
                         const float* __restrict__ scal, int cq, int cb,
                         int weighted, int robust, float* __restrict__ P) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* bins_b = bins_c + static_cast<size_t>(b) * cb * 8;
  const float delta = scal[1];
  float acc[kEntries];
#pragma unroll
  for (int j = 0; j < kEntries; ++j) acc[j] = 0.0f;

  icp::live::search_bin(
      mg + static_cast<size_t>(b) * cq * 8, 8, qvalid + static_cast<size_t>(b) * cq,
      bins_b, 8, sq_b + static_cast<size_t>(b) * cb, G, b_row, reps + b * 8, scal[0],
      cq, cb, kRow, smem,
      // ---- Weight; w and u.
      [&](const icp::live::Kept& q, float* o) {
        const float w = icp::match_weight(q.best, q.sq_q, q.valid, weighted, robust, delta);
        const float* f = bins_b + q.slot * 8;
        o[0] = q.qc[0];
        o[1] = q.qc[1];
        o[2] = q.qc[2];
        o[3] = 1.0f;
        o[4] = f[0];
        o[5] = f[1];
        o[6] = f[2];
        o[7] = 1.0f;
        o[8] = w;
      },
      // ---- P's entries: lane takes the kept queries of rank = lane mod 32.
      [&](const float* wu, int n_k, int n_done) {
        for (int k = (lane - n_done) & 31; k < n_k; k += 32) {
          const float* o = wu + k * kRow;
#pragma unroll
          for (int j = 0; j < kEntries; ++j) {
            const int e = warp + kWarps * j;
            if (e < 36) acc[j] = __fmaf_rn(__fmul_rn(o[kPairJ[e]], o[8]), o[kPairL[e]], acc[j]);
          }
        }
      });

  float* Pb = P + static_cast<size_t>(b) * 64;
#pragma unroll
  for (int j = 0; j < kEntries; ++j) {
    const int e = warp + kWarps * j;
    if (e >= 36) continue;  // uniform in the warp
    float s = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    if (lane == 0) {
      Pb[kPairJ[e] * 8 + kPairL[e]] = s;
      Pb[kPairL[e] * 8 + kPairJ[e]] = s;
    }
  }
}

}  // namespace

extern "C" int icp_bin_point_moments(const float* mg, const float* qvalid,
                                     const float* reps, const float* bins_c,
                                     const float* sq_b_masked, const float* G,
                                     const float* b_row, const float* scal,
                                     int n_r, int cq, int cb, int weighted,
                                     int robust, float* P, void* stream) {
  const size_t smem =
      icp::live::smem_floats(icp::live::tiles(cq, cb), kRow) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_point_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0) {
    bin_point_moments_kernel<<<n_r, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, scal, cq, cb,
        weighted, robust, P);
  }
  return static_cast<int>(cudaGetLastError());
}
