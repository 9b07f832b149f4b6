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
// What bounds it: at the flagship shape (n_r = 256 bins, cq = 96 query
// slots, cb = 128 bin slots) the search is 256 * 96 * 128 * 24 = 75 M exact
// bf16-product FMAs plus the 64-entry outer products; the inputs are ~1.4 MB.
// Neither the FP32 pipes nor HBM come close to their limits: the kernel is
// bound by latency, the serial loop over the cb slots of each thread and the
// block-wide reduction.
//
// Design: one block per bin, 128 threads, one query slot per thread (looping
// when cq > 128). The bin's bf16 halves and its masked |b|^2 row sit in
// shared memory (cb * 68 bytes; 8.7 KB at cb = 128), read by all threads of
// a warp at one address at a time (broadcast); the search and the weight are
// common.cuh's, shared with K4 and K7. The winner's centered point is read
// once from device memory. Each thread accumulates its 64 products
// w * u_j * u_l in registers; a fixed-order warp-shuffle tree and then a
// fixed-order sum over the four warps reduce them, so P is deterministic from
// run to run. The robust scale delta is read on the device (scal[1]), as an
// adaptive delta is computed there.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bin_point_moments_kernel(const float* __restrict__ mg,
                         const float* __restrict__ qvalid,
                         const float* __restrict__ reps,
                         const float* __restrict__ bins_c,
                         const float* __restrict__ sq_b,
                         const float* __restrict__ G,
                         const float* __restrict__ b_row,
                         const float* __restrict__ scal, int cq, int cb,
                         int weighted, int robust, float* __restrict__ P) {
  extern __shared__ float smem[];
  __shared__ float g[64];
  __shared__ float off[8];
  __shared__ float red[kWarps * 64];

  const int b = blockIdx.x;
  const float* bins_b = bins_c + static_cast<size_t>(b) * cb * 8;
  const icp::BinStage bin =
      icp::stage_bin(smem, bins_b, 8, sq_b + static_cast<size_t>(b) * cb, cb);
  if (threadIdx.x < 64) g[threadIdx.x] = G[threadIdx.x];
  if (threadIdx.x < 8) {
    off[threadIdx.x] = __fsub_rn(b_row[threadIdx.x], reps[b * 8 + threadIdx.x]);
  }
  __syncthreads();

  const float alpha = scal[0];
  const float delta = scal[1];
  const float w8[8] = {1.0f, 1.0f, 1.0f, 0.0f, alpha, alpha, alpha, 0.0f};
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  for (int i = threadIdx.x; i < cq; i += blockDim.x) {
    const size_t slot = static_cast<size_t>(b) * cq + i;
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = mg[slot * 8 + k];
    const icp::Match m = icp::search(p, qvalid[slot], g, off, w8, bin, cb);
    const float w = icp::match_weight(m, weighted, robust, delta);
    const float* f = bins_b + m.slot * 8;
    const float u[8] = {m.qc[0], m.qc[1], m.qc[2], 1.0f, f[0], f[1], f[2], 1.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float uw = u[j] * w;
#pragma unroll
      for (int l = 0; l < 8; ++l) acc[j * 8 + l] = fmaf(uw, u[l], acc[j * 8 + l]);
    }
  }
  icp::block_sum<64>(acc, red, P + static_cast<size_t>(b) * 64);
}

}  // namespace

extern "C" int icp_bin_point_moments(const float* mg, const float* qvalid,
                                     const float* reps, const float* bins_c,
                                     const float* sq_b_masked, const float* G,
                                     const float* b_row, const float* scal,
                                     int n_r, int cq, int cb, int weighted,
                                     int robust, float* P, void* stream) {
  const size_t smem = static_cast<size_t>(cb) * 17 * sizeof(float);
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
