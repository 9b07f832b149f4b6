// K5: per-bin exhaustive search of the unfused RBC pipeline.
//
// Replaces bin_search_pallas (icp_tpu/kernels/bin_search.py:115). For each
// grouped query slot i of bin b:
//   best[b, i]    = min_c (sq_b[b, c] - 2 * dot3(qg_w[b, i], bins_c[b, c]))
//   matched[b, i] = vals[b, c*, :]         (c* the first argmin)
// dot3 is the bf16x3 score contraction of common.cuh (dot3_8_fma, bit for bit
// the plain twin bin_search_ref's lane order), so kernel and twin pick the
// same slot. The TPU kernel gathers the payload with a one-hot HIGHEST
// matmul, an exact gather; here the winner's V floats are copied. A bin whose slots are all
// +inf returns +inf and slot 0's (finite) payload, as argmin does.
//
// What bounds it: at the flagship shape (n_r = 256, cq = 96, cb = 128) the
// search is 3.1 M slot pairs of three 8-lane products, ~0.2 GFLOP of
// non-fused float32 work, and ~1.3 MB of reads: the launch and the serial
// loop over the bin's slots of each thread.
//
// Design: one block per (bin, tile of 128 query slots), one slot per thread.
// The bin is staged in shared memory as bf16 halves plus |b|^2 in tiles of
// 512 rows (34 KB), so any bin capacity runs without the large-shared-memory
// opt-in; every thread of a warp reads the same row (a broadcast). A strict
// < over increasing slots, tile after tile, is the first minimum.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

__global__ void __launch_bounds__(kThreads)
bin_search_kernel(const float* __restrict__ qg_w, const float* __restrict__ bins_c,
                  const float* __restrict__ sq_b, const float* __restrict__ vals,
                  int cq, int cb, int v, float* __restrict__ best_score,
                  float* __restrict__ matched) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  float q_hi[8], q_lo[8];
  const float* q = qg_w + (static_cast<size_t>(b) * cq + s) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) icp::bf16_split(s < cq ? q[k] : 0.0f, q_hi[k], q_lo[k]);

  float best = icp::inf();
  int slot = 0;
  for (int base = 0; base < cb; base += kTile) {
    const int rows = min(kTile, cb - base);
    __syncthreads();  // the previous tile is consumed
    const size_t row0 = static_cast<size_t>(b) * cb + base;
    const icp::BinStage bin = icp::stage_bin(smem, bins_c + row0 * 8, 8, sq_b + row0, rows);
    __syncthreads();
    for (int c = 0; c < rows; ++c) {
      const float score =
          icp::score_fma(bin.sq[c], icp::dot3_8_fma(q_hi, q_lo, bin.hi + c * 8, bin.lo + c * 8));
      if (score < best) {
        best = score;
        slot = base + c;
      }
    }
  }
  if (s < cq) {
    const size_t out = static_cast<size_t>(b) * cq + s;
    best_score[out] = best;
    const float* src = vals + (static_cast<size_t>(b) * cb + slot) * v;
    float* dst = matched + out * v;
    for (int l = 0; l < v; ++l) dst[l] = src[l];
  }
}

}  // namespace

extern "C" int icp_bin_search(const float* qg_w, const float* bins_c,
                              const float* sq_b_masked, const float* vals, int n_r,
                              int cq, int cb, int v, float* best_score,
                              float* matched, void* stream) {
  const size_t smem = static_cast<size_t>(cb < kTile ? cb : kTile) * 17 * sizeof(float);
  const dim3 grid(n_r, (cq + kThreads - 1) / kThreads);
  if (n_r > 0 && cq > 0 && cb > 0) {
    bin_search_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        qg_w, bins_c, sq_b_masked, vals, cq, cb, v, best_score, matched);
  }
  return static_cast<int>(cudaGetLastError());
}
