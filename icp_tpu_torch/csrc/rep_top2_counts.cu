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
// order (kernels/knn_moments.py, rep_top2_counts_ref), so kernel and twin
// split near-ties alike. Each 3-lane part sum is one __fmul_rn and two
// __fmaf_rn: every product of two bf16 parts is exact in float32 (also on
// raw LiDAR coordinates, tests/test_torch_exact_fma.py), so the FMA rounds
// where the twin's separate add does (common.cuh, dot3_8_fma).
//
// What bounds it: m * n_r pairs of ~21 fp32 operations each (three 3-lane
// products, their sums, the score and two compares): 1.1e10 at the LiDAR
// shape (m = 262144, n_r = 2048), ~0.17 ms at 67 TFLOP/s, against ~5 MB of
// memory traffic (~1.5 us). It is bound by instruction issue, outside the
// tensor cores: ~19 instructions a pair, 12 arithmetic and 6 of the top-2
// update (two compares, four selects: half-rate on the ALU pipe).
//
// Design (K1's, rep_assign_counts.cu, on 3 lanes with a top-2):
// - The representatives are staged through shared memory in chunks of
//   kChunk, each as two 16-byte vectors [hi0 hi1 hi2 lo0 | lo1 lo2 srow .]
//   read by a whole warp at one address (a broadcast); srow is computed on
//   staging, so the wrapper launches nothing else. The stages are double
//   buffered: the next chunk is loaded into registers while the current
//   one is searched, then split and stored. Shared memory does not grow
//   with n_r apart from the 2 x n_r histogram, and that only while it fits.
// - Each thread keeps the bf16 halves of kQ points in registers (8 where
//   there are points enough to fill the card, else 4), so every staged rep
//   feeds kQ pairs, with a running (b1, r1, b2, r2) per point and
//   strict compares (s < b1: the old first becomes the second; else s < b2).
//   Over increasing ids that is the lexicographic (score, id) top 2, which
//   equals the reference's two first-minimum passes on every tie pattern.
//   The initial (+inf, 0) is what the reference gives where every score but
//   the first choice's is +inf: its masked row is all +inf, argmin 0.
// - The eight warps of a block share its 32 * kQ points and split each
//   chunk's reps. Their partial top-2 lists merge in (score, id) order: i1
//   is the least entry, i2 the least of the rest. +inf is never recorded
//   (a strict < against +inf fails), so every +inf entry is (+inf, 0).
// - Counts go to a shared-memory histogram with integer atomics, then to the
//   global (2, n_r) counts, zeroed by the wrapper: exact, and the bincounts
//   of the kernel's own ids. Where the 2 x n_r histogram does not fit beside
//   the stages (n_r above ~24 900 on an H100, as the estimator's automatic
//   n_r reaches from 2^21 + 128 points on), each id is counted with an
//   integer atomic straight into the global counts: the counts are exact
//   integers, so the order of the atomics changes nothing and the ids and
//   counts stay bitwise the twin's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;        // reps per stage: one per thread
constexpr int kSpan = kChunk / kWarps;  // reps of a stage per warp
constexpr int kStageFloats = kChunk * 8;

// Floats of the two stages, which the merge of 32 * kq points reuses (four
// words per warp and point).
__host__ __device__ constexpr int area_floats(int kq) {
  return 2 * kStageFloats > 4 * kWarps * 32 * kq ? 2 * kStageFloats : 4 * kWarps * 32 * kq;
}

// Global reads of rep r into registers (zeros past n_r).
__device__ __forceinline__ void load_rep(const float* __restrict__ reps, int n_r, int r,
                                         float (&c)[3]) {
  const bool in = r < n_r;
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = in ? reps[static_cast<size_t>(r) * 3 + k] : 0.0f;
}

// Split the loaded rep into its bf16 halves and store it in slot i with
// srow = |r|^2, one rounding per operation in lane order (the twin's
// lane_dot(reps, reps)).
__device__ __forceinline__ void store_rep(float* stage, int i, const float (&c)[3]) {
  float hi[3], lo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) icp::bf16_split(c[k], hi[k], lo[k]);
  const float s = icp::lane_dot<3>(c, c, 1);
  float4* dst = reinterpret_cast<float4*>(stage) + i * 2;
  dst[0] = make_float4(hi[0], hi[1], hi[2], lo[0]);
  dst[1] = make_float4(lo[1], lo[2], s, 0.0f);
}

// sum_k a[k] * b[k] over 3 lanes in lane order: one rounding per step, the
// twin's lane_dot on exact products.
__device__ __forceinline__ float dot3_lanes(float a0, float a1, float a2, float b0,
                                            float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// Insert (v, r) into the lexicographic (score, id) top 2 (B1, R1) < (B2, R2).
__device__ __forceinline__ void insert2(float v, int r, float& B1, int& R1, float& B2,
                                        int& R2) {
  if (v < B1 || (v == B1 && r < R1)) {
    B2 = B1;
    R2 = R1;
    B1 = v;
    R1 = r;
  } else if (v < B2 || (v == B2 && r < R2)) {
    B2 = v;
    R2 = r;
  }
}

// kQ points per thread; kSharedHist: the counts go through a shared
// histogram (else straight to the global counts).
template <int kQ, bool kSharedHist>
__global__ void __launch_bounds__(kThreads, 2)
rep_top2_counts_kernel(const float* __restrict__ p3,
                       const float* __restrict__ reps, int m, int n_r,
                       int* __restrict__ i1, int* __restrict__ i2,
                       int* __restrict__ counts) {
  constexpr int kQB = 32 * kQ;  // points per block
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                                          // [2][kStageFloats]
  // [2][n_r] in shared memory, or the global counts themselves.
  int* hist = kSharedHist ? reinterpret_cast<int*>(smem + area_floats(kQ)) : counts;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQB;

  if (kSharedHist) {
    for (int i = threadIdx.x; i < 2 * n_r; i += kThreads) hist[i] = 0;
  }

  // The points' bf16 halves, kQ per thread: point q0 + j * 32 + lane.
  float a_hi[kQ][3], a_lo[kQ][3], b1[kQ], b2[kQ];
  int r1[kQ], r2[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int q = q0 + j * 32 + lane;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = q < m ? p3[static_cast<size_t>(q) * 3 + k] : 0.0f;
      icp::bf16_split(x, a_hi[j][k], a_lo[j][k]);
    }
    b1[j] = b2[j] = icp::inf();
    r1[j] = r2[j] = 0;
  }

  float c[3];
  load_rep(reps, n_r, threadIdx.x, c);
  store_rep(stages, threadIdx.x, c);
  __syncthreads();

  const int n_chunks = (n_r + kChunk - 1) / kChunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const bool more = ci + 1 < n_chunks;
    if (more) load_rep(reps, n_r, (ci + 1) * kChunk + threadIdx.x, c);
    const float4* st = reinterpret_cast<const float4*>(stages + (ci & 1) * kStageFloats);
    const int c0 = ci * kChunk;
    const int lo_i = warp * kSpan;
    const int hi_i = min(lo_i + kSpan, n_r - c0);
    for (int i = lo_i; i < hi_i; ++i) {
      const float4 v0 = st[i * 2], v1 = st[i * 2 + 1];  // hi0 hi1 hi2 lo0 | lo1 lo2 srow
      const int r = c0 + i;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float hh = dot3_lanes(a_hi[j][0], a_hi[j][1], a_hi[j][2], v0.x, v0.y, v0.z);
        const float hl = dot3_lanes(a_hi[j][0], a_hi[j][1], a_hi[j][2], v0.w, v1.x, v1.y);
        const float lh = dot3_lanes(a_lo[j][0], a_lo[j][1], a_lo[j][2], v0.x, v0.y, v0.z);
        const float sc = icp::score_fma(v1.z, __fadd_rn(__fadd_rn(hh, hl), lh));
        const bool lt1 = sc < b1[j];
        const bool lt2 = sc < b2[j];
        b2[j] = lt1 ? b1[j] : (lt2 ? sc : b2[j]);
        r2[j] = lt1 ? r1[j] : (lt2 ? r : r2[j]);
        b1[j] = lt1 ? sc : b1[j];
        r1[j] = lt1 ? r : r1[j];
      }
    }
    if (more) store_rep(stages + ((ci + 1) & 1) * kStageFloats, threadIdx.x, c);
    __syncthreads();
  }

  // Merge the warps' partial top-2 lists per point, in the stage memory
  // (free after the last barrier).
  float* red_b1 = stages;  // [kWarps][kQB] each
  int* red_r1 = reinterpret_cast<int*>(red_b1 + kWarps * kQB);
  float* red_b2 = reinterpret_cast<float*>(red_r1 + kWarps * kQB);
  int* red_r2 = reinterpret_cast<int*>(red_b2 + kWarps * kQB);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int at = warp * kQB + j * 32 + lane;
    red_b1[at] = b1[j];
    red_r1[at] = r1[j];
    red_b2[at] = b2[j];
    red_r2[at] = r2[j];
  }
  __syncthreads();
  if (threadIdx.x < kQB) {
    const int t = threadIdx.x;
    float B1 = red_b1[t], B2 = red_b2[t];
    int R1 = red_r1[t], R2 = red_r2[t];
    for (int w = 1; w < kWarps; ++w) {
      insert2(red_b1[w * kQB + t], red_r1[w * kQB + t], B1, R1, B2, R2);
      insert2(red_b2[w * kQB + t], red_r2[w * kQB + t], B1, R1, B2, R2);
    }
    const int q = q0 + t;
    if (q < m) {
      i1[q] = R1;
      i2[q] = R2;
      atomicAdd(&hist[R1], 1);
      atomicAdd(&hist[n_r + R2], 1);
    }
  }
  if (!kSharedHist) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * n_r; i += kThreads) {
    const int h = hist[i];
    if (h != 0) atomicAdd(&counts[i], h);
  }
}

template <int kQ>
int launch(const float* p3, const float* reps, int m, int n_r, int* i1, int* i2,
           int* counts, cudaStream_t stream) {
  const size_t stage = area_floats(kQ) * sizeof(float);
  const size_t with_hist = stage + 2 * static_cast<size_t>(n_r) * sizeof(int);
  const bool shared_hist = with_hist <= static_cast<size_t>(icp::smem_optin());
  const size_t smem = shared_hist ? with_hist : stage;
  auto kernel = shared_hist ? rep_top2_counts_kernel<kQ, true> : rep_top2_counts_kernel<kQ, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m + 32 * kQ - 1) / (32 * kQ);
  if (blocks > 0) kernel<<<blocks, kThreads, smem, stream>>>(p3, reps, m, n_r, i1, i2, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int icp_rep_top2_counts(const float* p3, const float* reps, int m,
                                   int n_r, int* i1, int* i2, int* counts,
                                   void* stream) {
  // Eight points a thread halve the staged reads a pair where there are
  // points enough to fill the card (256 blocks at 65536); four below.
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return m >= 65536 ? launch<8>(p3, reps, m, n_r, i1, i2, counts, st)
                    : launch<4>(p3, reps, m, n_r, i1, i2, counts, st);
}
