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
// (kernels/knn_moments.py, bin_knn_moments_ref): n equals the twin's bitwise,
// and the components differ only by the order of the W-sums. A NaN query
// gets n = 1 and C = 0.
//
// The bisection needs one value of the row, not 18 counts. Every mid is
// finite or +inf and never NaN, so #{d2 <= mid} = n_ninf + #{finite d2 <=
// mid} (a -inf d2 counts, a NaN or +inf one does not; at mid = +inf the
// count is at least k_eff anyway). With kk = k_eff - n_ninf, the test holds
// iff kk <= 0 or v <= mid, v the kk-th smallest finite d2 counted with
// multiplicity. The kernel selects v exactly once, then runs the 18 halvings
// on scalars with the twin's rounding (__fmul_rn(0.5f, __fadd_rn(lo, hi))):
// hi, and so W and n, are the twin's bit for bit
// (tests/test_torch_knn_select.py emulates this against the twin).
//
// The selection: an upper bound U of v, then an exact rank among the finite
// d2 <= U. For kk <= 32, U is the kk-th smallest of the 32 lanes' minima (kk
// distinct slots lie at or below it; a bitonic sort across the warp); for
// larger kk, or where fewer than kk lanes hold a finite value, U = +inf. The
// slots <= U are compacted by ballot (a few dozen at the estimator's shapes;
// every finite slot where the row is tied), and v = max{x : #{y < x} < kk}.
//
// What bounds it: the d2 cross, ~21 fp32 operations per query and live
// candidate, plus ~40 per admitted neighbour and ~100 per query: ~2.4e9 at
// the LiDAR shape (n_r 2048, cq 192, cb 384 with ~250 live, k 16), ~0.036
// ms at 67 TFLOP/s, against ~26 MB of reads and writes (~8 us). Bound by
// operations, outside the tensor cores; in practice by the instructions
// each warp spends per query beside the cross (~1000: the selection, the
// halvings, two ballot passes and the W-sums).
//
// Design: a grid of (bin, query tile); each block stages its bin's live
// candidates (occupied, finite |c|^2: every other slot has a non-finite d2
// for every query) in slot order by a stable ballot compaction, centred, as
// three 16-byte vectors a slot: (b_hi, sq_b), (b_lo, 0), (c, 0). One warp
// per query; the warp's d2 row (computed once, lane-strided) and its
// selection buffer live in shared memory (2 cb floats a warp; the block
// takes fewer warps where cb is large, so shared memory grows with cb,
// never with cq x cb). Where even one warp's area does not fit (cb above
// ~4150 on an H100, as an explicit small n_r gives: cb 6144 at n_r 128 on
// 262144 points), or the query tiles would pass the grid's second
// dimension, the same arrays live in a global workspace that the wrapper
// allocates, one area a block: each block takes a bin and a span of its
// query tiles, staged once, and the items run in launches of as many blocks
// as there are areas. Shared memory then does not depend on cb, no grid
// dimension on cq, and the arithmetic, and so every output bit, is the same.
// The d2 cross takes one multiply and two FMAs per bf16 part product sum:
// each product of two bf16 parts is exact in float32, so an FMA rounds
// where the twin's add does (common.cuh, dot3_8_fma), and so does the
// scaled subtraction (score_fma). The W-sums
// run over the compacted admitted slots (~k of cb) on 27 lanes: lane
// 9 g + e sums entry e (M2's six, then S1's three) over the slots t = g mod
// 3 in slot order, the three groups join in a fixed order, and two shuffles
// bring S1 to the M2 lanes.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kQueriesPerWarp = 2;  // a block's query tile: warps x this
constexpr int kBisectIters = 18;
constexpr int kStageFloats = 12;    // per live candidate: 3 float4
constexpr int kSumGroups = 3;       // lanes 9 g + e, g < 3, sum entry e
constexpr unsigned kFull = 0xffffffffu;
// Entry e < 6 is M2's (kUi[e], kUj[e]) (c00 c01 c02 c11 c12 c22); entry
// 6 + j is S1[j].
__constant__ int kUi[9] = {0, 0, 0, 1, 1, 2, 0, 1, 2};
__constant__ int kUj[9] = {0, 1, 2, 1, 2, 2, 0, 0, 0};

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : v.z);
}

// sum_j a[j] * b[j] over 3 lanes where every product is exact (bf16 parts):
// equal to icp::lane_dot<3> bit for bit.
__device__ __forceinline__ float dot3_parts(const float a[3], const float4& b) {
  return __fmaf_rn(a[2], b.z, __fmaf_rn(a[1], b.y, __fmul_rn(a[0], b.x)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// The kk-th smallest finite value (with multiplicity) of row[0:n], for
// 1 <= kk <= #finite; lmin is the lane's least finite value of its strip
// row[lane::32] (+inf if none). sel holds n floats. Warp-uniform result.
__device__ float select_kth(const float* row, float* sel, int n, int kk,
                            float lmin, int lane) {
  float u = icp::inf();
  if (kk <= 32) {  // bitonic sort of the lane minima, ascending by lane
    float x = lmin;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float y = __shfl_xor_sync(kFull, x, stride);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        x = keep_min ? fminf(x, y) : fmaxf(x, y);
      }
    }
    u = __shfl_sync(kFull, x, kk - 1);
  }
  int n_s = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const float d = j < n ? row[j] : icp::inf();
    const bool in = icp::is_finite(d) && d <= u;
    const unsigned m = __ballot_sync(kFull, in);
    if (in) sel[n_s + __popc(m & lanes_below(lane))] = d;
    n_s += __popc(m);
  }
  __syncwarp();
  float v = -icp::inf();
  for (int i = lane; i < n_s; i += 32) {
    const float x = sel[i];
    int less = 0;
    for (int t = 0; t < n_s; ++t) less += sel[t] < x ? 1 : 0;
    if (less < kk) v = fmaxf(v, x);
  }
  return warp_max(v);
}

// Floats of a block's area: 3 float4 a slot, then each warp's d2 row and
// selection buffer.
__host__ __device__ inline size_t area_floats(int cb, int warps) {
  return static_cast<size_t>(cb) * (kStageFloats + 2 * warps);
}

// kWs false: the area is dynamic shared memory and block (x, y) takes bin x
// and query tile y. kWs true: block x takes item item0 + x of the bin-major
// (bin, span of `span` query tiles) order, in the area
// ws + x * area_floats(cb, warps).
template <bool kWs>
__global__ void __launch_bounds__(kMaxWarps * 32)
bin_knn_moments_kernel(const float* __restrict__ qp, int ld_q,
                       const float* __restrict__ bins,
                       const float* __restrict__ reps,
                       const unsigned char* __restrict__ bvalid, int n_r,
                       int cq, int cb, int k, float* __restrict__ out,
                       float* ws, int item0, int span) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_live[kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int tile = warps * kQueriesPerWarp;
  int b = blockIdx.x, ti = blockIdx.y;
  float4* area = smem4;
  if (kWs) {
    const int per_bin = ((cq + tile - 1) / tile + span - 1) / span;
    const int item = item0 + blockIdx.x;
    b = item / per_bin;
    ti = (item - b * per_bin) * span;
    area = reinterpret_cast<float4*>(ws + blockIdx.x * area_floats(cb, warps));
  }
  float4* hi_sq = area;          // [cb] bf16 hi halves of the centred c, |c|^2
  float4* lo_h = hi_sq + cb;     // [cb] bf16 lo halves
  float4* cc = lo_h + cb;        // [cb] the centred candidates
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* row = reinterpret_cast<float*>(cc + cb) + warp * 2 * cb;  // [cb] d2 row
  float* sel = row + cb;                 // [cb] selection, then admitted slots
  int* adm = reinterpret_cast<int*>(sel);

  const float rep[3] = {reps[b * 3], reps[b * 3 + 1], reps[b * 3 + 2]};
  const float* brow = bins + static_cast<size_t>(b) * cb * 3;
  int n_live = 0;
  for (int c0 = 0; c0 < cb; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float v[3] = {0.0f, 0.0f, 0.0f};
    float s = 0.0f;
    bool ok = false;
    if (c < cb) {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = __fsub_rn(brow[c * 3 + j], rep[j]);
      s = icp::lane_dot<3>(v, v, 1);
      ok = bvalid[static_cast<size_t>(b) * cb + c] != 0 && icp::is_finite(s);
    }
    const unsigned mask = __ballot_sync(kFull, ok);
    if (lane == 0) warp_live[warp] = __popc(mask);
    __syncthreads();
    int base = n_live, total = 0;
    for (int w = 0; w < warps; ++w) {
      base += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (ok) {  // a finite |c|^2 has finite coordinates
      const int p = base + __popc(mask & lanes_below(lane));
      float h[3], l[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) icp::bf16_split(v[j], h[j], l[j]);
      hi_sq[p] = make_float4(h[0], h[1], h[2], s);
      lo_h[p] = make_float4(l[0], l[1], l[2], 0.0f);
      cc[p] = make_float4(v[0], v[1], v[2], 0.0f);
    }
    n_live += total;
    __syncthreads();
  }

  const int e = lane % 9;          // the entry this lane sums
  const int g = lane / 9;          // its group (3: idle)
  const int ui = kUi[e];
  const int uj = kUj[e];
  const size_t plane = static_cast<size_t>(n_r) * cq;
  // A span of tiles ends at cq at the latest, computed without overflow.
  const int q_end = kWs ? ti * tile + min(cq - ti * tile, span * tile)
                        : min(cq, (ti + 1) * tile);
  for (int i = ti * tile + warp; i < q_end; i += warps) {
    const float* qrow = qp + (static_cast<size_t>(b) * cq + i) * ld_q;
    float q[3], q_hi[3], q_lo[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q[j] = __fsub_rn(qrow[j], rep[j]);
      icp::bf16_split(q[j], q_hi[j], q_lo[j]);
    }
    const float sq_q = icp::lane_dot<3>(q, q, 1);

    int n_fin = 0, n_ninf = 0;
    float mx = -icp::inf(), lmin = icp::inf();
    for (int j = lane; j < n_live; j += 32) {
      const float4 ch = hi_sq[j];
      const float4 cl = lo_h[j];
      const float cross = __fadd_rn(__fadd_rn(dot3_parts(q_hi, ch), dot3_parts(q_hi, cl)),
                                    dot3_parts(q_lo, ch));
      const float v = __fadd_rn(icp::score_fma(sq_q, cross), ch.w);
      row[j] = v;
      const bool fin = icp::is_finite(v);
      n_fin += fin ? 1 : 0;
      n_ninf += v == -icp::inf() ? 1 : 0;
      mx = fmaxf(mx, fin ? v : 0.0f);
      lmin = fin ? fminf(lmin, v) : lmin;
    }
    n_fin = __reduce_add_sync(kFull, n_fin);
    n_ninf = __reduce_add_sync(kFull, n_ninf);
    mx = warp_max(mx);
    // Slots left out of staging have a non-finite d2: the twin's 0.
    if (n_live < cb) mx = fmaxf(mx, 0.0f);
    const int kk = min(k, n_fin) - n_ninf;
    const float v = kk > 0 ? select_kth(row, sel, n_live, kk, lmin, lane) : 0.0f;

    float hi = __fadd_rn(mx, 1.0f);
    float lo = -1.0f;
    for (int it = 0; it < kBisectIters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (kk <= 0 || v <= mid) {
        hi = mid;
      } else {
        lo = mid;
      }
    }

    __syncwarp();  // sel is read; adm overwrites it
    int n_w = 0;
    for (int j0 = 0; j0 < n_live; j0 += 32) {
      const int j = j0 + lane;
      const float d = j < n_live ? row[j] : icp::inf();
      const bool in = d <= hi && icp::is_finite(d);
      const unsigned m = __ballot_sync(kFull, in);
      if (in) adm[n_w + __popc(m & lanes_below(lane))] = j;
      n_w += __popc(m);
    }
    __syncwarp();

    float a_hi = 0.0f, a_lo = 0.0f;
    if (g < kSumGroups) {
      for (int t = g; t < n_w; t += kSumGroups) {
        const float4 c = cc[adm[t]];
        const float a = lane_of(c, ui);
        const float x = e < 6 ? __fmul_rn(a, lane_of(c, uj)) : a;
        float x_hi, x_lo;
        icp::bf16_split(x, x_hi, x_lo);
        a_hi = __fadd_rn(a_hi, x_hi);
        a_lo = __fadd_rn(a_lo, x_lo);
      }
    }
    // Group 0 joins groups 1 and 2: (g0 + g1) + g2, hi and lo apart.
    a_hi = __fadd_rn(__fadd_rn(a_hi, __shfl_down_sync(kFull, a_hi, 9)),
                     __shfl_down_sync(kFull, a_hi, 18));
    a_lo = __fadd_rn(__fadd_rn(a_lo, __shfl_down_sync(kFull, a_lo, 9)),
                     __shfl_down_sync(kFull, a_lo, 18));
    const float sum = __fadd_rn(a_hi, a_lo);  // M2 entry (lanes 0-5), S1 (6-8)
    const float s1a = __shfl_sync(kFull, sum, 6 + ui);
    const float s1b = __shfl_sync(kFull, sum, 6 + uj);
    const float n = static_cast<float>(max(n_w, 1));
    const size_t slot = static_cast<size_t>(b) * cq + i;
    if (lane < 6) {
      out[lane * plane + slot] = __fsub_rn(sum, __fdiv_rn(__fmul_rn(s1a, s1b), n));
    } else if (lane == 6) {
      out[6 * plane + slot] = n;
    }
    __syncwarp();  // adm is read; the next query's row and selection reuse it
  }
}

// The launch for capacities (n_r, cq, cb) on the current device: warps a
// block and dynamic shared memory, or, where a block's area does not fit in
// shared memory or the query tiles pass the grid's second dimension, the
// areas of the workspace (blocks a launch), its floats and the query tiles
// a block spans.
struct Plan {
  int warps;
  size_t smem;
  int ws_blocks;
  size_t ws_floats;
  int span;
};

int n_tiles(int cq, int warps) {
  const int tile = warps * kQueriesPerWarp;
  return (cq + tile - 1) / tile;
}

Plan plan(int n_r, int cq, int cb) {
  // The static warp_live beside the area.
  const int limit = icp::smem_optin() - static_cast<int>(kMaxWarps * sizeof(int));
  // Fewer warps where cb is large: each holds 2 cb floats beside the stage.
  Plan p{kMaxWarps, 0, 0, 0, 1};
  while (p.warps > 1 && area_floats(cb, p.warps) * sizeof(float) > static_cast<size_t>(limit))
    --p.warps;
  p.smem = area_floats(cb, p.warps) * sizeof(float);
  if (p.smem <= static_cast<size_t>(limit) && n_tiles(cq, p.warps) <= icp::kMaxGridY) return p;
  // The workspace: eight warps a block, four blocks an SM a launch, fewer
  // where the workspace would pass 512 MiB; the blocks share the bins out,
  // each bin's query tiles split in equal spans among its share.
  p.warps = kMaxWarps;
  p.smem = 0;
  const size_t per_block = area_floats(cb, kMaxWarps);
  const long long budget = static_cast<long long>((size_t{1} << 27) / per_block);
  p.ws_blocks = static_cast<int>(std::max(1LL, std::min(4LL * icp::sm_count(), budget)));
  p.ws_floats = per_block * static_cast<size_t>(p.ws_blocks);
  const int share = std::max(1, p.ws_blocks / std::max(n_r, 1));
  p.span = (n_tiles(cq, kMaxWarps) + share - 1) / share;
  return p;
}

}  // namespace

// Floats of the global workspace that icp_bin_knn_moments needs at these
// capacities (0: none, the block's area fits in shared memory).
extern "C" int icp_bin_knn_moments_workspace(int n_r, int cq, int cb, long long* floats) {
  *floats = static_cast<long long>(plan(n_r, cq, cb).ws_floats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int icp_bin_knn_moments(const float* qp, int ld_q, const float* bins,
                                   const float* reps, const unsigned char* bvalid,
                                   int n_r, int cq, int cb, int k, float* out, float* ws,
                                   void* stream) {
  const Plan p = plan(n_r, cq, cb);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_r <= 0 || cq <= 0) return static_cast<int>(cudaGetLastError());
  if (p.ws_floats > 0) {
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int per_bin = (n_tiles(cq, p.warps) + p.span - 1) / p.span;
    const long long n_items = static_cast<long long>(n_r) * per_bin;
    if (n_items > INT_MAX) {
      return icp::launch_limit("bin_knn_moments (%d, %d, %d): %lld work items, over 2^31 - 1",
                               n_r, cq, cb, n_items);
    }
    for (int item0 = 0; item0 < n_items; item0 += p.ws_blocks) {
      const int blocks = static_cast<int>(std::min<long long>(p.ws_blocks, n_items - item0));
      bin_knn_moments_kernel<true><<<blocks, p.warps * 32, 0, st>>>(
          qp, ld_q, bins, reps, bvalid, n_r, cq, cb, k, out, ws, item0, p.span);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_knn_moments_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_knn_moments_kernel<false><<<dim3(n_r, n_tiles(cq, p.warps)), p.warps * 32, p.smem, st>>>(
      qp, ld_q, bins, reps, bvalid, n_r, cq, cb, k, out, nullptr, 0, 1);
  return static_cast<int>(cudaGetLastError());
}
