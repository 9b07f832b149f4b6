// K6: exact brute-force nearest neighbour.
//
// Replaces brute_nn_pallas (icp_tpu/kernels/brute_nn.py:69). For each
// metric-weighted query qw[i] (8 floats) it returns
//   idx[i]   = argmin_j (sq_db[j] - 2 * qw[i] . db[j])   (first minimum)
//   score[i] = that minimum
// over the whole (n, 8) database. The dot product is full float32 (the TPU
// kernel's HIGHEST precision), rounded once per multiply and per add in lane
// order, so the plain twin (brute_nn_ref) computes the same scores bitwise.
//
// What bounds it: arithmetic. At 16384 x 16384 the sweep is 2.7e8 pairs of
// 8 multiplies, 8 adds and a compare, ~4.6 GFLOP of non-fused float32
// operations; the reads are tiny (the database, 0.5 MB, stays in L2).
//
// Design: a block holds 32 queries and 8 database slices (256 threads). The
// database streams through shared memory in tiles of 1024 rows; within a
// tile, slice s scans rows [128 s, 128 s + 128) for every query of the
// block, so the 32 threads of a warp read the same row at once (a shared
// memory broadcast). Each thread keeps a strict-< running minimum over
// increasing indices (the first minimum of its rows); the 8 slices of a
// query are then merged on (score, index), which is the first minimum over
// all rows, the tie-break of the TPU kernel's argmin carry. Any m and n.
#include "common.cuh"

namespace {

constexpr int kQueries = 32;
constexpr int kSlices = 8;
constexpr int kThreads = kQueries * kSlices;
constexpr int kTile = 1024;
constexpr int kRowsPerSlice = kTile / kSlices;

__global__ void __launch_bounds__(kThreads)
brute_nn_kernel(const float* __restrict__ qw, const float* __restrict__ db,
                const float* __restrict__ sq_db, int m, int n,
                int* __restrict__ idx, float* __restrict__ score) {
  __shared__ float s_db[kTile * 8];
  __shared__ float s_sq[kTile];
  __shared__ float r_best[kThreads];
  __shared__ int r_idx[kThreads];

  const int lane_q = threadIdx.x % kQueries;
  const int slice = threadIdx.x / kQueries;
  const int q = blockIdx.x * kQueries + lane_q;
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = q < m ? qw[static_cast<size_t>(q) * 8 + k] : 0.0f;
  }

  float best = icp::inf();
  int best_i = 0;
  for (int base = 0; base < n; base += kTile) {
    const int rows = min(kTile, n - base);
    __syncthreads();  // the previous tile is consumed
    const float* src = db + static_cast<size_t>(base) * 8;
    for (int i = threadIdx.x; i < rows * 8; i += kThreads) s_db[i] = src[i];
    for (int i = threadIdx.x; i < rows; i += kThreads) s_sq[i] = sq_db[base + i];
    __syncthreads();
    const int hi = min((slice + 1) * kRowsPerSlice, rows);
    for (int c = slice * kRowsPerSlice; c < hi; ++c) {
      const float cross = icp::lane_dot<8>(a, s_db + c * 8, 1);
      const float sc = __fsub_rn(s_sq[c], __fmul_rn(2.0f, cross));
      if (sc < best) {
        best = sc;
        best_i = base + c;
      }
    }
  }

  r_best[threadIdx.x] = best;
  r_idx[threadIdx.x] = best_i;
  __syncthreads();
  if (slice == 0 && q < m) {
#pragma unroll
    for (int s = 1; s < kSlices; ++s) {
      const float b = r_best[s * kQueries + lane_q];
      const int i = r_idx[s * kQueries + lane_q];
      if (b < best || (b == best && i < best_i)) {
        best = b;
        best_i = i;
      }
    }
    idx[q] = best_i;
    score[q] = best;
  }
}

}  // namespace

extern "C" int icp_brute_nn(const float* qw, const float* db, const float* sq_db,
                            int m, int n, int* idx, float* score, void* stream) {
  const int blocks = (m + kQueries - 1) / kQueries;
  if (blocks > 0 && n > 0) {
    brute_nn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        qw, db, sq_db, m, n, idx, score);
  }
  return static_cast<int>(cudaGetLastError());
}
