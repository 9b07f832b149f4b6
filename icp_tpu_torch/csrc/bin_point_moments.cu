// K3: per-bin nearest-neighbour search + weighting + 8x8 moment reduction.
//
// Replaces bin_point_moments_pallas (icp_tpu/kernels/fused_step.py:564),
// whose body is _score_core / _search_core / _moment_math (:449-547). For
// each bin b and each query slot i of its grouped table:
//   qc   = p @ G + (b_row - rep_b)            transformed, rep-centered query
//   s_c  = sq_b[b, c] - 2 dot3(qc * w8, bins_c[b, c])    (+inf on bad slots)
//   c*   = first argmin_c s_c,   d2 = max(s_c* + |qc|^2_w, 0)
//   w    = qvalid * (|p_xyz|_1 > 0) * isfinite(s_c*) * [100 / (100 + d2)]
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
// when cq > 128). The bin's centered points, their bf16 halves and its
// masked |b|^2 row sit in shared memory (cb * 100 bytes; 12.8 KB at
// cb = 128), read by all threads of a warp at one address at a time
// (broadcast). The scores round exactly where the plain twin does (see
// common.cuh), so kernel and twin pick the same neighbours. Each thread
// accumulates its 64 products w * u_j * u_l in registers; a fixed-order
// warp-shuffle tree and then a fixed-order sum over the four warps reduce
// them, so P is deterministic from run to run.
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
                         const float* __restrict__ alpha_ptr, int cq, int cb,
                         int weighted, float* __restrict__ P) {
  extern __shared__ float smem[];
  float* b_hi = smem;             // [cb][8]
  float* b_lo = b_hi + cb * 8;    // [cb][8]
  float* b_raw = b_lo + cb * 8;   // [cb][8]
  float* s_sq = b_raw + cb * 8;   // [cb]
  __shared__ float g[64];
  __shared__ float off[8];
  __shared__ float red[kWarps][64];

  const int b = blockIdx.x;
  const float* bins_b = bins_c + static_cast<size_t>(b) * cb * 8;
  for (int i = threadIdx.x; i < cb * 8; i += blockDim.x) {
    const float v = bins_b[i];
    b_raw[i] = v;
    icp::bf16_split(v, b_hi[i], b_lo[i]);
  }
  for (int i = threadIdx.x; i < cb; i += blockDim.x) {
    s_sq[i] = sq_b[static_cast<size_t>(b) * cb + i];
  }
  if (threadIdx.x < 64) g[threadIdx.x] = G[threadIdx.x];
  if (threadIdx.x < 8) {
    off[threadIdx.x] = __fsub_rn(b_row[threadIdx.x], reps[b * 8 + threadIdx.x]);
  }
  __syncthreads();

  const float alpha = *alpha_ptr;
  const float w8[8] = {1.0f, 1.0f, 1.0f, 0.0f, alpha, alpha, alpha, 0.0f};
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  for (int i = threadIdx.x; i < cq; i += blockDim.x) {
    const size_t slot = static_cast<size_t>(b) * cq + i;
    float p[8], qc[8], qw[8], q_hi[8], q_lo[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = mg[slot * 8 + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qc[j] = __fadd_rn(icp::lane_dot<8>(p, g + j, 8), off[j]);
      qw[j] = __fmul_rn(qc[j], w8[j]);
      icp::bf16_split(qw[j], q_hi[j], q_lo[j]);
    }
    const float sq_q = icp::lane_dot<8>(qw, qc, 1);

    float best = icp::inf();
    int best_c = 0;
    for (int c = 0; c < cb; ++c) {
      const float cross = icp::dot3_8(q_hi, q_lo, b_hi + c * 8, b_lo + c * 8, 1);
      const float score = __fsub_rn(s_sq[c], __fmul_rn(2.0f, cross));
      if (score < best) {
        best = score;
        best_c = c;
      }
    }

    const float vo = (fabsf(p[0]) + fabsf(p[1]) + fabsf(p[2])) > 0.0f ? 1.0f : 0.0f;
    // best is +inf exactly when every slot of the bin is masked.
    const float finite = fabsf(best) <= 3.402823466e38f ? 1.0f : 0.0f;
    float w = __fmul_rn(__fmul_rn(qvalid[slot], vo), finite);
    if (weighted) {
      const float d2 = fmaxf(__fadd_rn(best, sq_q), 0.0f);
      w = __fmul_rn(w, __fdiv_rn(100.0f, __fadd_rn(100.0f, d2)));
    }
    const float* f = b_raw + best_c * 8;
    const float u[8] = {qc[0], qc[1], qc[2], 1.0f, f[0], f[1], f[2], 1.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float uw = u[j] * w;
#pragma unroll
      for (int l = 0; l < 8; ++l) acc[j * 8 + l] = fmaf(uw, u[l], acc[j * 8 + l]);
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    float v = acc[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += red[k][threadIdx.x];
    P[static_cast<size_t>(b) * 64 + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int icp_bin_point_moments(const float* mg, const float* qvalid,
                                     const float* reps, const float* bins_c,
                                     const float* sq_b_masked, const float* G,
                                     const float* b_row, const float* alpha,
                                     int n_r, int cq, int cb, int weighted,
                                     float* P, void* stream) {
  const size_t smem = static_cast<size_t>(cb) * 25 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_point_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0) {
    bin_point_moments_kernel<<<n_r, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, alpha, cq, cb,
        weighted, P);
  }
  return static_cast<int>(cudaGetLastError());
}
