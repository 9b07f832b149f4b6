// K9: the first and second nearest representative of every raw 3-D point,
// with the per-choice bin counts.
//
// Replaces rep_top2_counts_pallas (icp_tpu/kernels/knn_moments.py:223).
// For each point p (3 floats, raw and uncentred) and representative r:
//   score[r]  = srow[r] - 2 * dot3(p, r),   srow[r] = |r|^2 (lane order)
//   i1[q]     = first argmin_r score[r]
//   i2[q]     = first argmin over r != i1[q] (only that one id is masked)
//   counts[0][b] = #{q : i1[q] == b},  counts[1][b] = #{q : i2[q] == b}
// The counts include invalid (zero-geometry) points, as the reference's do.
// The cancellation of raw coordinates (z ~ 1500 mm) is the reference's
// semantics and is kept: the score is the bf16x3 dot3 in the twin's lane
// order with one IEEE rounding per operation (common.cuh), so kernel and
// twin (kernels/knn_moments.py, rep_top2_counts_ref) split near-ties alike.
//
// What bounds it: m * n_r pairs of ~21 fp32 operations each (three 3-lane
// products, their sums, the score and two compares): 1.1e10 at the LiDAR
// shape (m = 262144, n_r = 2048), ~0.17 ms at 67 TFLOP/s, against ~5 MB of
// memory traffic (~1.5 us). It is bound by operations, outside the tensor cores.
//
// Design: one point per thread, 256 threads per block, a serial loop over
// the representatives in increasing id. Their bf16 halves and srow sit in
// shared memory as [3][n_r] planes (7 * n_r floats), so a warp reads one
// broadcast element per step. A running (best1, best2) pair with strict
// compares (s < b1: b2 <- b1, b1 <- s; else s < b2: b2 <- s) equals the
// reference's two first-minimum passes on every tie pattern. Counts go to
// two shared-memory histograms (2 * n_r ints) and then to the global
// counts with integer atomics (exact, independent of order). At n_r = 2048
// the block needs 72 KB of shared memory: the launch opts in above 48 KB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rep_top2_counts_kernel(const float* __restrict__ p3,
                       const float* __restrict__ reps,
                       const float* __restrict__ srow, int m, int n_r,
                       int* __restrict__ i1, int* __restrict__ i2,
                       int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* r_hi = smem;               // [3][n_r]
  float* r_lo = r_hi + 3 * n_r;     // [3][n_r]
  float* s_row = r_lo + 3 * n_r;    // [n_r]
  int* hist = reinterpret_cast<int*>(s_row + n_r);  // [2][n_r]

  for (int i = threadIdx.x; i < 3 * n_r; i += blockDim.x) {
    const int lane = i / n_r;
    const int r = i - lane * n_r;
    icp::bf16_split(reps[r * 3 + lane], r_hi[i], r_lo[i]);
  }
  for (int i = threadIdx.x; i < n_r; i += blockDim.x) {
    s_row[i] = srow[i];
    hist[i] = 0;
    hist[n_r + i] = 0;
  }
  __syncthreads();

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < m) {
    float a_hi[3], a_lo[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      icp::bf16_split(p3[static_cast<size_t>(q) * 3 + k], a_hi[k], a_lo[k]);
    }
    float b1 = icp::inf(), b2 = icp::inf();
    int r1 = 0, r2 = 0;
    for (int r = 0; r < n_r; ++r) {
      const float hh = icp::lane_dot<3>(a_hi, r_hi + r, n_r);
      const float hl = icp::lane_dot<3>(a_hi, r_lo + r, n_r);
      const float lh = icp::lane_dot<3>(a_lo, r_hi + r, n_r);
      const float cross = __fadd_rn(__fadd_rn(hh, hl), lh);
      const float s = __fsub_rn(s_row[r], __fmul_rn(2.0f, cross));
      if (s < b1) {
        b2 = b1;
        r2 = r1;
        b1 = s;
        r1 = r;
      } else if (s < b2) {
        b2 = s;
        r2 = r;
      }
    }
    i1[q] = r1;
    i2[q] = r2;
    atomicAdd(&hist[r1], 1);
    atomicAdd(&hist[n_r + r2], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * n_r; i += blockDim.x) {
    const int c = hist[i];
    if (c != 0) atomicAdd(&counts[i], c);
  }
}

}  // namespace

extern "C" int icp_rep_top2_counts(const float* p3, const float* reps,
                                   const float* srow, int m, int n_r, int* i1,
                                   int* i2, int* counts, void* stream) {
  const size_t smem = static_cast<size_t>(n_r) * (7 * sizeof(float) + 2 * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rep_top2_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0) {
    rep_top2_counts_kernel<<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        p3, reps, srow, m, n_r, i1, i2, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
