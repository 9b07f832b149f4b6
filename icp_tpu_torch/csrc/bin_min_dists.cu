// K4: per-bin nearest-neighbour squared distances (the adaptive-robust pass).
//
// Replaces bin_min_dists_pallas (icp_tpu/kernels/fused_step.py:689), whose
// body is _min_dist_math (:661-674): K3's search without the moments. For
// each bin b and each query slot i of its grouped table:
//   d2[b, i] = max(min_c s_c + |qc|^2_w, 0)   if the slot is occupied, the
//                                             original point is non-zero and
//                                             the bin has a valid slot
//            = +inf                           otherwise
// with s_c the bf16x3 scores of common.cuh's search (prep_query, dot3_8_fma:
// the same rounding as K3 and K7, so the three kernels see the same nearest
// neighbours). The adaptive robust scale is the median of the finite
// entries (ops/moments.py).
//
// What bounds it: the same 75 M score FMAs as K3 at the flagship shape and
// one float written per slot (98 KB): latency of the serial slot loop, as in
// K3, with no reduction after it.
//
// Design: one block per bin, 128 threads, one query slot per thread; the bin
// is staged in shared memory by common.cuh's stage_bin (cb * 68 bytes). The
// query rows take a row stride, so lanes 0:8 of the 11-wide grouped
// (moving8 | normal) table of PLANE / GICP are read in place.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bin_min_dists_kernel(const float* __restrict__ mg, int ld_mg,
                     const float* __restrict__ qvalid,
                     const float* __restrict__ reps,
                     const float* __restrict__ bins_c,
                     const float* __restrict__ sq_b,
                     const float* __restrict__ G,
                     const float* __restrict__ b_row,
                     const float* __restrict__ scal, int cq, int cb,
                     float* __restrict__ d2) {
  extern __shared__ float smem[];
  __shared__ float g[64];
  __shared__ float off[8];

  const int b = blockIdx.x;
  const icp::BinStage bin =
      icp::stage_bin(smem, bins_c + static_cast<size_t>(b) * cb * 8, 8,
                     sq_b + static_cast<size_t>(b) * cb, cb);
  if (threadIdx.x < 64) g[threadIdx.x] = G[threadIdx.x];
  if (threadIdx.x < 8) {
    off[threadIdx.x] = __fsub_rn(b_row[threadIdx.x], reps[b * 8 + threadIdx.x]);
  }
  __syncthreads();

  const float alpha = scal[0];
  const float w8[8] = {1.0f, 1.0f, 1.0f, 0.0f, alpha, alpha, alpha, 0.0f};
  for (int i = threadIdx.x; i < cq; i += blockDim.x) {
    const size_t slot = static_cast<size_t>(b) * cq + i;
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = mg[slot * ld_mg + k];
    const icp::Match m = icp::search(p, qvalid[slot], g, off, w8, bin, cb);
    d2[slot] = (m.valid > 0.0f && icp::is_finite(m.best)) ? icp::match_d2(m.best, m.sq_q)
                                                           : icp::inf();
  }
}

}  // namespace

extern "C" int icp_bin_min_dists(const float* mg, int ld_mg,
                                 const float* qvalid,
                                 const float* reps, const float* bins_c,
                                 const float* sq_b_masked, const float* G,
                                 const float* b_row, const float* scal, int n_r,
                                 int cq, int cb, float* d2, void* stream) {
  const size_t smem = static_cast<size_t>(cb) * 17 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_min_dists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0) {
    bin_min_dists_kernel<<<n_r, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        mg, ld_mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, scal, cq, cb,
        d2);
  }
  return static_cast<int>(cudaGetLastError());
}
