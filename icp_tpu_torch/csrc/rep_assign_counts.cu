// K1: transform + nearest representative + per-bin counts, and K1', the
// same assignment without the counts.
//
// Replaces rep_assign_counts_pallas (icp_tpu/kernels/fused_step.py:372) and,
// through the kCounts = false instance, rep_assign_pallas (:286).
// For each raw moving row p (8 floats) it returns
//   rid[q]   = argmin_r (srow[r] - 2 * dot3(p, C[:, r]))   (first minimum)
//   counts[b] = #{q : rid[q] == b}                          (exact)
// where C (8, n_r) and srow (n_r) fold the accumulated similarity, the metric
// weights and the representative centering (prep_rep_assign).
//
// What bounds it: the FP32 instruction rate. Each (query, rep) pair is a
// bf16x3 score over 8 lanes, 24 exact bf16 products; at 262144 x 2048 that
// is 5.4e8 pairs, and the inputs are a few MB. With one instruction per product
// (common.cuh's dot3_8_fma: 3 FMUL + 21 FFMA, 2 FADD, the score's FFMA) and
// the compare and select, a pair costs ~30 instructions, ~0.5 ms on an H100.
//
// Design:
// - The representatives are staged through shared memory in chunks of
//   kChunk, each rep as [hi0..7 | lo0..7] (four 16-byte loads, read by a
//   whole warp at one address: a broadcast) plus srow. The stages are double
//   buffered: the next chunk's C columns are loaded into registers while the
//   current chunk is searched, then split into bf16 halves and stored (the
//   split is done on staging, so the loads go through registers rather than
//   cp.async). Shared memory no longer grows with n_r, apart from the
//   histogram while it fits: two blocks fit on an SM at n_r 2048.
// - Each thread keeps the bf16 halves of kQ queries in registers, so every
//   staged rep feeds kQ pairs, with a running (best, index) per query and a
//   strict < (the first minimum of the TPU kernel's min + iota select).
// - The eight warps of a block share its 32 * kQ queries and split each
//   chunk's reps between them, so the flagship shape (16384 x 256) still
//   gives 128 blocks. The warps' partial minima merge as (lower score, then
//   lower index), which is the global first minimum.
// - Counts go to a shared-memory histogram with integer atomics and then to
//   the global (n_r,) counts, zeroed by the wrapper: exact and independent
//   of order. Where the n_r histogram does not fit beside the stages (n_r
//   above ~49 400 on an H100), each rid is counted with an integer atomic
//   straight into the global counts, which is as exact. K1' is the same
//   template with the histogram compiled out, so its rid equals K1's
//   bitwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;                   // queries per thread
constexpr int kQB = 32 * kQ;            // queries per block
constexpr int kChunk = kThreads;        // reps per stage: one per thread
constexpr int kSpan = kChunk / kWarps;  // reps of a stage per warp
// One stage: kChunk reps of 16 halves (4 float4) and kChunk srow values.
constexpr int kStageFloats = kChunk * 17;

// Global reads of rep r's 8 C lanes and srow into registers (zeros past n_r).
__device__ __forceinline__ void load_rep(const float* __restrict__ C,
                                         const float* __restrict__ srow,
                                         int n_r, int r, float (&c)[8], float& s) {
  const bool in = r < n_r;
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = in ? C[static_cast<size_t>(k) * n_r + r] : 0.0f;
  s = in ? srow[r] : 0.0f;
}

// Split the loaded rep into its bf16 halves and store it in slot i.
__device__ __forceinline__ void store_rep(float* stage, int i, const float (&c)[8],
                                          float s) {
  float hi[8], lo[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) icp::bf16_split(c[k], hi[k], lo[k]);
  float4* dst = reinterpret_cast<float4*>(stage) + i * 4;
  dst[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
  dst[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
  dst[2] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  dst[3] = make_float4(lo[4], lo[5], lo[6], lo[7]);
  stage[kChunk * 16 + i] = s;
}

// kCounts: count the rids; kSharedHist: through a shared histogram (else
// straight to the global counts).
template <bool kCounts, bool kSharedHist>
__global__ void __launch_bounds__(kThreads, 2)
rep_assign_counts_kernel(const float* __restrict__ moving8,
                         const float* __restrict__ C,
                         const float* __restrict__ srow, int m, int n_r,
                         int* __restrict__ rid, int* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                                    // [2][kStageFloats]
  // [n_r] in shared memory, or the global counts themselves.
  int* hist = kSharedHist ? reinterpret_cast<int*>(smem + 2 * kStageFloats) : counts;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQB;

  if (kCounts && kSharedHist) {
    for (int i = threadIdx.x; i < n_r; i += kThreads) hist[i] = 0;
  }

  // The queries' bf16 halves, kQ per thread: query q0 + j * 32 + lane.
  float a_hi[kQ][8], a_lo[kQ][8], best[kQ];
  int best_r[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int q = q0 + j * 32 + lane;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (q < m) {
      const float4* row = reinterpret_cast<const float4*>(moving8) + static_cast<size_t>(q) * 2;
      v0 = row[0];
      v1 = row[1];
    }
    const float p[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) icp::bf16_split(p[k], a_hi[j][k], a_lo[j][k]);
    best[j] = icp::inf();
    best_r[j] = 0;
  }

  float c[8], s;
  load_rep(C, srow, n_r, threadIdx.x, c, s);
  store_rep(stages, threadIdx.x, c, s);
  __syncthreads();

  const int n_chunks = (n_r + kChunk - 1) / kChunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const bool more = ci + 1 < n_chunks;
    if (more) load_rep(C, srow, n_r, (ci + 1) * kChunk + threadIdx.x, c, s);
    const float* st = stages + (ci & 1) * kStageFloats;
    const float4* reps4 = reinterpret_cast<const float4*>(st);
    const int c0 = ci * kChunk;
    const int lo_i = warp * kSpan;
    const int hi_i = min(lo_i + kSpan, n_r - c0);
    for (int i = lo_i; i < hi_i; ++i) {
      const float4 h0 = reps4[i * 4], h1 = reps4[i * 4 + 1];
      const float4 l0 = reps4[i * 4 + 2], l1 = reps4[i * 4 + 3];
      const float b_hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float b_lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const float sr = st[kChunk * 16 + i];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float score = icp::score_fma(sr, icp::dot3_8_fma(a_hi[j], a_lo[j], b_hi, b_lo));
        if (score < best[j]) {
          best[j] = score;
          best_r[j] = c0 + i;
        }
      }
    }
    if (more) store_rep(stages + ((ci + 1) & 1) * kStageFloats, threadIdx.x, c, s);
    __syncthreads();
  }

  // Merge the warps' partial minima per query, in the stage memory (free
  // after the last barrier): (lower score, then lower index).
  float* red_s = stages;                                  // [kWarps][kQB]
  int* red_r = reinterpret_cast<int*>(stages + kWarps * kQB);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    red_s[warp * kQB + j * 32 + lane] = best[j];
    red_r[warp * kQB + j * 32 + lane] = best_r[j];
  }
  __syncthreads();
  if (threadIdx.x < kQB) {
    const int t = threadIdx.x;
    float b = red_s[t];
    int br = red_r[t];
    for (int w = 1; w < kWarps; ++w) {
      const float v = red_s[w * kQB + t];
      const int r = red_r[w * kQB + t];
      if (v < b || (v == b && r < br)) {
        b = v;
        br = r;
      }
    }
    const int q = q0 + t;
    if (q < m) {
      rid[q] = br;
      if (kCounts) atomicAdd(&hist[br], 1);
    }
  }
  if (!kCounts || !kSharedHist) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_r; i += kThreads) {
    const int h = hist[i];
    if (h != 0) atomicAdd(&counts[i], h);
  }
}

template <bool kCounts>
int launch(const float* moving8, const float* C, const float* srow, int m,
           int n_r, int* rid, int* counts, cudaStream_t stream) {
  const size_t stage = 2 * kStageFloats * sizeof(float);
  const size_t with_hist = stage + static_cast<size_t>(n_r) * sizeof(int);
  const bool shared_hist = kCounts && with_hist <= static_cast<size_t>(icp::smem_optin());
  const size_t smem = shared_hist ? with_hist : stage;
  auto kernel = shared_hist ? rep_assign_counts_kernel<kCounts, true>
                            : rep_assign_counts_kernel<kCounts, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m + kQB - 1) / kQB;
  if (blocks > 0) kernel<<<blocks, kThreads, smem, stream>>>(moving8, C, srow, m, n_r, rid, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int icp_rep_assign_counts(const float* moving8, const float* C,
                                     const float* srow, int m, int n_r,
                                     int* rid, int* counts, void* stream) {
  return launch<true>(moving8, C, srow, m, n_r, rid, counts,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int icp_rep_assign(const float* moving8, const float* C,
                              const float* srow, int m, int n_r, int* rid,
                              void* stream) {
  return launch<false>(moving8, C, srow, m, n_r, rid, nullptr,
                       static_cast<cudaStream_t>(stream));
}
