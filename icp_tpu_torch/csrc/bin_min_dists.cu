// K4: per-bin nearest-neighbour squared distances (the adaptive-robust pass).
//
// Replaces bin_min_dists_pallas (icp_tpu/kernels/fused_step.py:689), whose
// body is _min_dist_math (:661-674): K3's search without the moments. For
// each bin b and each query slot i of its grouped table:
//   d2[b, i] = max(min_c s_c + |qc|^2_w, 0)   if the slot is occupied, the
//                                             original point is non-zero and
//                                             the bin has a valid slot
//            = +inf                           otherwise
// with s_c the bf16x3 scores of bin_search_phase.cuh's search (prep_query,
// dot3_8_fma: the same rounding as K3 and K7, so the three kernels see the
// same nearest neighbours). The adaptive robust scale is the median of the
// finite entries (ops/moments.py).
//
// What bounds it: the FP32 instruction rate of the search over the pairs the
// data holds (the qvalid != 0 query slots times the live slots of their bin,
// ~30 instructions a pair), and at the flagship shape (n_r 256, cq 96, cb
// 128, ~61 live slots a bin) the latency of one short block per bin: the
// last-live scan, the staging, the search and the merge.
//
// Design: the search is bin_search_phase.cuh's, shared with K3 and K7, run
// by one block of 256 threads per bin and query tile of up to 256 slots
// (K3 and K7 walk a bin's query tiles in one block for their reduction's
// order; K4 has no reduction, so with few, large bins its tiles fill more
// of the card: 96 blocks at n_r 8, cq 3072). In each block: the bin cut at
// its last live slot; the qvalid != 0 query slots kept by an order-keeping
// ballot; bin tiles of up to 512 slots, so shared memory is bounded
// whatever cq and cb are (24 KB at the flagship, 74 KB at cq 3072 / cb
// 4096, n_r 8); (chunk of >= 16 live slots, kept query) items over all 256
// threads, merged in slot order: the first minimum. Each kept query writes
// its d2 straight to global memory (emit); there is nothing to reduce. The
// slots that were not kept get +inf from a pass before the search: their
// addresses and the kept slots' are disjoint. The query rows take a row
// stride, so lanes 0:8 of the 11-wide grouped (moving8 | normal) table of
// PLANE / GICP are read in place.
#include "bin_search_phase.cuh"

namespace {

using icp::live::kQTile;
using icp::live::kThreads;

// One block per (bin, tile of kQTile query slots): with no reduction after
// the search, the query tiles of a bin are independent.
__global__ void __launch_bounds__(kThreads, 2)
bin_min_dists_kernel(const float* __restrict__ mg, int ld_mg,
                     const float* __restrict__ qvalid,
                     const float* __restrict__ reps,
                     const float* __restrict__ bins_c,
                     const float* __restrict__ sq_b,
                     const float* __restrict__ G,
                     const float* __restrict__ b_row,
                     const float* __restrict__ scal, int cq, int cb,
                     float* __restrict__ d2) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int nq = min(kQTile, cq - q0);
  const size_t slot0 = static_cast<size_t>(b) * cq + q0;
  const float* qv = qvalid + slot0;
  float* d2_t = d2 + slot0;
  // The slots search_bin does not keep (qvalid == 0).
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    if (!(qv[i] != 0.0f)) d2_t[i] = icp::inf();
  }
  icp::live::search_bin(
      mg + slot0 * ld_mg, ld_mg, qv, bins_c + static_cast<size_t>(b) * cb * 8, 8,
      sq_b + static_cast<size_t>(b) * cb, G, b_row, reps + b * 8, scal[0], nq, cb, 0, smem,
      [&](const icp::live::Kept& q, float*) {
        d2_t[q.q] = (q.valid > 0.0f && icp::is_finite(q.best)) ? icp::match_d2(q.best, q.sq_q)
                                                                : icp::inf();
      },
      [](const float*, int, int) {});
}

}  // namespace

extern "C" int icp_bin_min_dists(const float* mg, int ld_mg,
                                 const float* qvalid,
                                 const float* reps, const float* bins_c,
                                 const float* sq_b_masked, const float* G,
                                 const float* b_row, const float* scal, int n_r,
                                 int cq, int cb, float* d2, void* stream) {
  const size_t smem =
      icp::live::smem_floats(icp::live::tiles(cq, cb), 0) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_min_dists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0 && cq > 0) {
    const dim3 grid(n_r, (cq + kQTile - 1) / kQTile);
    if (grid.y > static_cast<unsigned>(icp::kMaxGridY)) {
      return icp::launch_limit(
          "bin_min_dists (%d, %d, %d): %u query tiles of %d, over the grid's second "
          "dimension %d", n_r, cq, cb, grid.y, kQTile, icp::kMaxGridY);
    }
    bin_min_dists_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        mg, ld_mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, scal, cq, cb,
        d2);
  }
  return static_cast<int>(cudaGetLastError());
}
