// K1: transform + nearest representative + per-bin counts.
//
// Replaces rep_assign_counts_pallas (icp_tpu/kernels/fused_step.py:372).
// For each raw moving row p (8 floats) it returns
//   rid[q]   = argmin_r (srow[r] - 2 * dot3(p, C[:, r]))   (first minimum)
//   counts[b] = #{q : rid[q] == b}                          (exact)
// where C (8, n_r) and srow (n_r) fold the accumulated similarity, the metric
// weights and the representative centering (prep_rep_assign).
//
// What bounds it: at the flagship shape (m = 16384, n_r = 256) the work is
// m * n_r * 24 = 101 M exact bf16-product FMAs and ~0.5 MB of reads, a few
// microseconds of an H100 at any reasonable efficiency: the kernel is bound
// by its launch and by the serial loop over r of each thread.
//
// Design: one query per thread, 256 threads per block. The bf16 halves of C
// and srow sit in shared memory (17 * n_r floats; 17 KB at n_r = 256) and
// every thread of a warp reads the same element at the same time (a
// broadcast, no bank conflicts). Each thread keeps a running strict-<
// minimum, which is the first-minimum tie-break of the TPU kernel's
// min + iota select. Counts go to a shared-memory histogram with integer
// atomics and then to the global (n_r,) counts, zeroed by the wrapper:
// integer atomics are exact and independent of order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rep_assign_counts_kernel(const float* __restrict__ moving8,
                         const float* __restrict__ C,
                         const float* __restrict__ srow, int m, int n_r,
                         int* __restrict__ rid, int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* c_hi = smem;                 // [8][n_r]
  float* c_lo = c_hi + 8 * n_r;       // [8][n_r]
  float* s_row = c_lo + 8 * n_r;      // [n_r]
  int* hist = reinterpret_cast<int*>(s_row + n_r);  // [n_r]

  for (int i = threadIdx.x; i < 8 * n_r; i += blockDim.x) {
    icp::bf16_split(C[i], c_hi[i], c_lo[i]);
  }
  for (int i = threadIdx.x; i < n_r; i += blockDim.x) {
    s_row[i] = srow[i];
    hist[i] = 0;
  }
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < m) {
    float a_hi[8], a_lo[8];
    const float* row = moving8 + static_cast<size_t>(q) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) icp::bf16_split(row[k], a_hi[k], a_lo[k]);
    float best = icp::inf();
    int best_r = 0;
    for (int r = 0; r < n_r; ++r) {
      const float cross = icp::dot3_8(a_hi, a_lo, c_hi + r, c_lo + r, n_r);
      const float score = __fsub_rn(s_row[r], __fmul_rn(2.0f, cross));
      if (score < best) {
        best = score;
        best_r = r;
      }
    }
    rid[q] = best_r;
    atomicAdd(&hist[best_r], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_r; i += blockDim.x) {
    const int c = hist[i];
    if (c != 0) atomicAdd(&counts[i], c);
  }
}

}  // namespace

extern "C" int icp_rep_assign_counts(const float* moving8, const float* C,
                                     const float* srow, int m, int n_r,
                                     int* rid, int* counts, void* stream) {
  const size_t smem = static_cast<size_t>(n_r) * (17 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rep_assign_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0) {
    rep_assign_counts_kernel<<<blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        moving8, C, srow, m, n_r, rid, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
