// K8: per-query kNN covariance components of the RBC normal estimator.
//
// Replaces bin_knn_moments_pallas (icp_tpu/kernels/knn_moments.py:158), the
// reference's _knn_math (:53-124). For bin b, with queries q and candidates
// c centred on reps[b]:
//   sq_b[c] = |c|^2, +inf where the slot is empty or the point invalid (NaN)
//   d2[q,c] = (|q|^2 - 2 * dot3(q, c)) + sq_b[c]
//   k_eff   = min(k, #finite d2[q, :])
//   18 halvings of [lo, hi] = [-1, max(finite d2, or 0) + 1]: mid = (lo+hi)/2,
//   hi = mid where #{d2 <= mid} >= k_eff, else lo = mid
//   W[c]    = d2[q,c] <= hi and finite;  n = max(#W, 1)
//   S1 = sum_W c, M2 = sum_W c c^T, each as (sum of bf16 hi parts) + (sum of
//   lo parts): dot3 with a 0/1 left side, the reference's rounding
//   C = M2 - S1 S1^T / n  -> c00, c01, c02, c11, c12, c22 and n
// The bisection is not an exact k-th selection: it may admit a few tied or
// nearly tied extras, and the kernel admits the same ones as its twin
// (kernels/knn_moments.py, bin_knn_moments_ref) because d2 and every
// bisection step are rounded in the twin's order (__fmul_rn / __fadd_rn,
// no contraction): n equals the twin's bitwise, and the components differ
// only by the order of the W-sums. A NaN query gets n = 1 and C = 0.
//
// What bounds it: n_r * cq * cb query-candidate pairs of ~60 fp32
// operations (the d2 cross, 18 compare-and-count passes, the membership
// test) plus ~40 per admitted neighbour: ~9.4e9 at the LiDAR shape
// (n_r 2048, cq 192, cb 384, k 16), ~0.14 ms at 67 TFLOP/s, against ~26 MB
// of reads and writes (~8 us). It is bound by operations, outside the
// tensor cores.
//
// Design: one block per bin, one warp per query (8 warps take the bin's
// queries in turn). The block stages the bin's centred candidates (NaN
// zeroed), their bf16 halves and sq_b in shared memory (10 floats a slot);
// each warp keeps its query's d2 row in shared memory (cb floats), so no
// per-candidate value goes back to device memory and any cb fits while
// 18 * cb floats do (opt-in above 48 KB). Each lane owns the slots
// lane, lane + 32, ...; a bisection step is a compare per slot and a warp
// sum (__reduce_add_sync: integer counts equal the twin's float counts below
// 2^24). The W-sums touch only the admitted slots (~k of cb), with the
// products c_i c_j formed and split on the fly, then a warp-shuffle sum.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 18;
constexpr unsigned kFull = 0xffffffffu;
// The 6 unique entries (i, j) of a symmetric 3x3: c00 c01 c02 c11 c12 c22.
__constant__ int kUi[6] = {0, 0, 0, 1, 1, 2};
__constant__ int kUj[6] = {0, 1, 2, 1, 2, 2};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
bin_knn_moments_kernel(const float* __restrict__ qp, int ld_q,
                       const float* __restrict__ bins,
                       const float* __restrict__ reps,
                       const unsigned char* __restrict__ bvalid, int n_r,
                       int cq, int cb, int k, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* bc = smem;              // [cb][3] centred candidates, NaN -> 0
  float* b_hi = bc + cb * 3;     // [cb][3] bf16 halves of bc
  float* b_lo = b_hi + cb * 3;   // [cb][3]
  float* sq = b_lo + cb * 3;     // [cb] masked |c|^2
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* d2 = sq + cb + warp * cb;  // [cb] this warp's query row

  const float rep[3] = {reps[b * 3], reps[b * 3 + 1], reps[b * 3 + 2]};
  const float* brow = bins + static_cast<size_t>(b) * cb * 3;
  for (int c = threadIdx.x; c < cb; c += blockDim.x) {
    float v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = __fsub_rn(brow[c * 3 + j], rep[j]);
    const float s = icp::lane_dot<3>(v, v, 1);
    const bool ok = bvalid[static_cast<size_t>(b) * cb + c] != 0 && icp::is_finite(s);
    sq[c] = ok ? s : icp::inf();
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float z = icp::is_finite(v[j]) ? v[j] : 0.0f;
      bc[c * 3 + j] = z;
      icp::bf16_split(z, b_hi[c * 3 + j], b_lo[c * 3 + j]);
    }
  }
  __syncthreads();

  for (int i = warp; i < cq; i += kWarps) {
    const float* qrow = qp + (static_cast<size_t>(b) * cq + i) * ld_q;
    float q[3], q_hi[3], q_lo[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q[j] = __fsub_rn(qrow[j], rep[j]);
      icp::bf16_split(q[j], q_hi[j], q_lo[j]);
    }
    const float sq_q = icp::lane_dot<3>(q, q, 1);

    int n_fin = 0;
    float mx = -icp::inf();
    for (int c = lane; c < cb; c += 32) {
      const float hh = icp::lane_dot<3>(q_hi, b_hi + c * 3, 1);
      const float hl = icp::lane_dot<3>(q_hi, b_lo + c * 3, 1);
      const float lh = icp::lane_dot<3>(q_lo, b_hi + c * 3, 1);
      const float cross = __fadd_rn(__fadd_rn(hh, hl), lh);
      const float v = __fadd_rn(__fsub_rn(sq_q, __fmul_rn(2.0f, cross)), sq[c]);
      d2[c] = v;
      const bool fin = icp::is_finite(v);
      n_fin += fin ? 1 : 0;
      mx = fmaxf(mx, fin ? v : 0.0f);
    }
    n_fin = __reduce_add_sync(kFull, n_fin);
    mx = warp_max(mx);
    const int k_eff = min(k, n_fin);

    float hi = __fadd_rn(mx, 1.0f);
    float lo = -1.0f;
    for (int it = 0; it < kBisectIters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int cnt = 0;
      for (int c = lane; c < cb; c += 32) cnt += d2[c] <= mid ? 1 : 0;
      cnt = __reduce_add_sync(kFull, cnt);
      if (cnt >= k_eff) {
        hi = mid;
      } else {
        lo = mid;
      }
    }

    // acc: S1 hi [0:3], S1 lo [3:6], M2 hi [6:12], M2 lo [12:18].
    float acc[18];
#pragma unroll
    for (int e = 0; e < 18; ++e) acc[e] = 0.0f;
    int n_w = 0;
    for (int c = lane; c < cb; c += 32) {
      const float v = d2[c];
      if (!(v <= hi && icp::is_finite(v))) continue;
      ++n_w;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        acc[j] = __fadd_rn(acc[j], b_hi[c * 3 + j]);
        acc[3 + j] = __fadd_rn(acc[3 + j], b_lo[c * 3 + j]);
      }
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        float x_hi, x_lo;
        icp::bf16_split(__fmul_rn(bc[c * 3 + kUi[u]], bc[c * 3 + kUj[u]]), x_hi, x_lo);
        acc[6 + u] = __fadd_rn(acc[6 + u], x_hi);
        acc[12 + u] = __fadd_rn(acc[12 + u], x_lo);
      }
    }
#pragma unroll
    for (int e = 0; e < 18; ++e) acc[e] = warp_sum(acc[e]);
    n_w = __reduce_add_sync(kFull, n_w);

    if (lane == 0) {
      const float n = static_cast<float>(max(n_w, 1));
      float s1[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) s1[j] = __fadd_rn(acc[j], acc[3 + j]);
      const size_t slot = static_cast<size_t>(b) * cq + i;
      const size_t plane = static_cast<size_t>(n_r) * cq;
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const float m2 = __fadd_rn(acc[6 + u], acc[12 + u]);
        const float outer = __fmul_rn(s1[kUi[u]], s1[kUj[u]]);
        out[u * plane + slot] = __fsub_rn(m2, __fdiv_rn(outer, n));
      }
      out[6 * plane + slot] = n;
    }
  }
}

}  // namespace

extern "C" int icp_bin_knn_moments(const float* qp, int ld_q, const float* bins,
                                   const float* reps, const unsigned char* bvalid,
                                   int n_r, int cq, int cb, int k, float* out,
                                   void* stream) {
  const size_t smem = static_cast<size_t>(cb) * (10 + kWarps) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_knn_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0 && cq > 0) {
    bin_knn_moments_kernel<<<n_r, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        qp, ld_q, bins, reps, bvalid, n_r, cq, cb, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}
