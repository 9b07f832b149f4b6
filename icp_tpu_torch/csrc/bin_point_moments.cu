// K3: per-bin nearest-neighbour search + weighting + 8x8 moment reduction.
//
// Replaces bin_point_moments_pallas (icp_tpu/kernels/fused_step.py:564),
// whose body is _score_core / _search_core / _moment_math (:449-547). For
// each bin b and each query slot i of its grouped table:
//   qc   = p @ G + (b_row - rep_b)            transformed, rep-centered query
//   s_c  = sq_b[b, c] - 2 dot3(qc * w8, bins_c[b, c])    (+inf on bad slots)
//   c*   = first argmin_c s_c,   d2 = max(s_c* + |qc|^2_w, 0)
//   w    = qvalid * (|p_xyz|_1 > 0) * isfinite(s_c*) * [100 / (100 + d2)]
//          * [robust_factor(d2, delta)]
//   u    = [qc_xyz, 1, bins_c[b, c*]_xyz, 1]
//   P_b  = sum_i w u u^T                                      (8 x 8)
//
// What bounds it: the FP32 instruction rate of the search, ~30
// instructions per (query, slot) pair (common.cuh's dot3_8_fma, the score's
// FFMA, compare and select), over the pairs the data holds: the valid query
// slots times the live slots of their bin. The inputs are a few MB.
//
// Design: one block of 256 threads per bin. Shared memory is bounded
// (74 KB at most) whatever the capacities: the block walks the query slots
// in tiles of up to 256 and the bin in tiles of up to 512 slots. At the
// main path's shapes (cq <= 256, cb <= 512) each is one tile and the bin is
// staged once.
// - Only live pairs are searched. The block finds the bin's last slot whose
//   masked |b|^2 is not +inf (or NaN) and searches no slot past it; in each
//   query tile it keeps the slots with qvalid != 0 (an order-keeping ballot
//   compaction). Both skips are exact: +inf and NaN never win a strict <
//   against a best that starts at +inf, and a dropped slot's weight is 0,
//   so its terms of P are exact zeros.
// - The bin is staged as bf16 halves [c][hi0..7 | lo0..7] beside its masked
//   |b|^2 row. Each kept query is transformed and split once (common.cuh's
//   lane_dot, as icp::search does), into shared memory. The work items are
//   (chunk of bin slots, query): at least kCs slots a chunk, and at most
//   kPart items a tile, so the (best, slot) table stays bounded. They
//   spread over all 256 threads whatever cq and cb are, so no pass leaves
//   half the block idle; neighbouring threads take neighbouring queries of
//   one chunk and read its slots at one address (a broadcast). Each item
//   keeps a running strict-< minimum; the chunks, then the bin tiles, merge
//   in slot order with strict <, which is the first minimum. The scores are
//   dot3_8_fma's, bit for bit icp::search's (K4, K7).
// - The reduction holds no 8x8 accumulator: each kept query writes w and u
//   to shared memory, and each warp sums some of the 36 distinct entries of
//   the symmetric P over the kept queries, lane l taking every query whose
//   rank among the bin's kept queries is l mod 32, in rank order across the
//   query tiles; then a fixed shuffle tree, mirrored into both triangles. P
//   repeats bitwise from run to run.
// - The robust scale delta is read on the device (scal[1]), as an adaptive
//   delta is computed there.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = kThreads;  // query slots per tile, a multiple of 32
constexpr int kBTile = 512;       // bin slots per staged tile
constexpr int kCs = 16;           // least bin slots per search item
constexpr int kPart = 2048;       // most (best, slot) entries per tile
constexpr int kMeta = 5;          // per kept query: qc_xyz, |qc|^2_w, valid
constexpr int kEntries = (36 + kWarps - 1) / kWarps;  // P entries per warp

// The 36 (j, l), j <= l, entries of the symmetric 8x8 P.
__constant__ unsigned char kPairJ[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
    2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 6, 6, 7};
__constant__ unsigned char kPairL[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5, 6, 7, 2, 3, 4,
    5, 6, 7, 3, 4, 5, 6, 7, 4, 5, 6, 7, 5, 6, 7, 6, 7, 7};

// Tile sizes for capacities (cq, cb), and the floats of dynamic shared
// memory they need.
struct Tiles {
  int qt;    // query slots per tile
  int bt;    // bin slots per tile
  int part;  // (best, slot) entries
};

__host__ __device__ inline Tiles tiles(int cq, int cb) {
  Tiles t;
  const int q32 = (cq + 31) / 32 * 32;
  t.qt = q32 < kQTile ? q32 : kQTile;
  t.bt = cb < kBTile ? cb : kBTile;
  const int items = (t.bt + kCs - 1) / kCs * t.qt;
  t.part = items < kPart ? items : kPart;
  return t;
}

__host__ __device__ inline size_t smem_floats(const Tiles& t) {
  return static_cast<size_t>(t.bt) * 17                // bin halves, |b|^2
         + static_cast<size_t>(t.qt) * (16 + kMeta + 3)  // query halves (then
                                                         // w, u), meta, running
                                                         // (best, slot), keep
         + static_cast<size_t>(t.part) * 2;              // per-item (best, slot)
}

// Two blocks per SM: at most 128 registers a thread.
__global__ void __launch_bounds__(kThreads, 2)
bin_point_moments_kernel(const float* __restrict__ mg,
                         const float* __restrict__ qvalid,
                         const float* __restrict__ reps,
                         const float* __restrict__ bins_c,
                         const float* __restrict__ sq_b,
                         const float* __restrict__ G,
                         const float* __restrict__ b_row,
                         const float* __restrict__ scal, int cq, int cb,
                         int weighted, int robust, float* __restrict__ P) {
  extern __shared__ __align__(16) float smem[];
  const Tiles t = tiles(cq, cb);
  float* bin = smem;                     // [bt][16]
  float* qh = bin + t.bt * 16;           // [qt][16], later w and u [qt][9]
  float* sq = qh + t.qt * 16;            // [bt]
  float* meta = sq + t.bt;               // [qt][kMeta]
  float* run_s = meta + t.qt * kMeta;    // [qt] best over the earlier bin tiles
  int* run_c = reinterpret_cast<int*>(run_s + t.qt);
  int* keep = run_c + t.qt;              // [qt] kept slots of the query tile
  float* part_s = reinterpret_cast<float*>(keep + t.qt);  // [part]
  int* part_c = reinterpret_cast<int*>(part_s + t.part);
  __shared__ float g[64];
  __shared__ float off[8];
  __shared__ int warp_n[kWarps];
  __shared__ int last_live;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* bins_b = bins_c + static_cast<size_t>(b) * cb * 8;
  const float* sq_bb = sq_b + static_cast<size_t>(b) * cb;
  const float* qv_b = qvalid + static_cast<size_t>(b) * cq;

  // The bin's slots [base, base + n) into bin and sq, by the whole block.
  auto stage = [&](int base, int n) {
    for (int i = threadIdx.x; i < n * 8; i += kThreads) {
      const int c = i >> 3, k = i & 7;
      icp::bf16_split(bins_b[base * 8 + i], bin[c * 16 + k], bin[c * 16 + 8 + k]);
    }
    for (int c = threadIdx.x; c < n; c += kThreads) sq[c] = sq_bb[base + c];
  };

  // ---- The bin's last live slot.
  if (threadIdx.x == 0) last_live = -1;
  if (threadIdx.x < 64) g[threadIdx.x] = G[threadIdx.x];
  if (threadIdx.x < 8) {
    off[threadIdx.x] = __fsub_rn(b_row[threadIdx.x], reps[b * 8 + threadIdx.x]);
  }
  int my_last = -1;
  for (int c = threadIdx.x; c < cb; c += kThreads) {
    if (sq_bb[c] < icp::inf()) my_last = c;  // false for +inf and NaN
  }
  __syncthreads();  // last_live = -1 is visible
  if (my_last >= 0) atomicMax(&last_live, my_last);
  __syncthreads();
  const int n_live = last_live + 1;
  const bool one_tile = n_live <= t.bt;
  if (one_tile) stage(0, n_live);

  const float alpha = scal[0];
  const float delta = scal[1];
  const float w8[8] = {1.0f, 1.0f, 1.0f, 0.0f, alpha, alpha, alpha, 0.0f};
  const float4* bin4 = reinterpret_cast<const float4*>(bin);
  const float4* qh4 = reinterpret_cast<const float4*>(qh);
  float* wu = qh;  // [n_k][9]: u[0..7], w
  float acc[kEntries];
#pragma unroll
  for (int j = 0; j < kEntries; ++j) acc[j] = 0.0f;
  int n_done = 0;  // kept queries of the earlier query tiles

  for (int qbase = 0; qbase < cq; qbase += t.qt) {
    // ---- Keep the tile's qvalid != 0 slots, in slot order.
    const int i = qbase + threadIdx.x;
    const bool v = threadIdx.x < t.qt && i < cq && qv_b[i] != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();  // warp_n; and the bin staged before the first tile
    int pos = __popc(ballot & ((1u << lane) - 1u));
    int n_k = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += warp_n[w];
      n_k += warp_n[w];
    }
    if (v) keep[pos] = i;
    __syncthreads();
    if (n_k == 0) continue;

    // ---- Each kept query: transform, center, weight, split (icp::search's).
    for (int k = threadIdx.x; k < n_k; k += kThreads) {
      const float* row = mg + (static_cast<size_t>(b) * cq + keep[k]) * 8;
      float p[8], qc[8], qw[8], hi[8], lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = row[j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qc[j] = __fadd_rn(icp::lane_dot<8>(p, g + j, 8), off[j]);
        qw[j] = __fmul_rn(qc[j], w8[j]);
        icp::bf16_split(qw[j], hi[j], lo[j]);
      }
      float4* dst = reinterpret_cast<float4*>(qh) + k * 4;
      dst[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      dst[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
      dst[2] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      dst[3] = make_float4(lo[4], lo[5], lo[6], lo[7]);
      const float vo = (fabsf(p[0]) + fabsf(p[1]) + fabsf(p[2])) > 0.0f ? 1.0f : 0.0f;
      float* mt = meta + k * kMeta;
      mt[0] = qc[0];
      mt[1] = qc[1];
      mt[2] = qc[2];
      mt[3] = icp::lane_dot<8>(qw, qc, 1);
      mt[4] = __fmul_rn(qv_b[keep[k]], vo);
      run_s[k] = icp::inf();
      run_c[k] = 0;
    }
    __syncthreads();

    for (int bbase = 0; bbase < n_live; bbase += t.bt) {
      const int n_t = min(n_live - bbase, t.bt);
      if (!one_tile) {
        stage(bbase, n_t);
        __syncthreads();
      }
      // ---- Search: items (chunk of len live slots, kept query).
      int n_ch = min((n_t + kCs - 1) / kCs, max(1, t.part / n_k));
      const int len = (n_t + n_ch - 1) / n_ch;
      n_ch = (n_t + len - 1) / len;
      const int items = n_ch * n_k;
      for (int it = threadIdx.x; it < items; it += kThreads) {
        const int ch = it / n_k;
        const int k = it - ch * n_k;
        const float4 h0 = qh4[k * 4], h1 = qh4[k * 4 + 1];
        const float4 l0 = qh4[k * 4 + 2], l1 = qh4[k * 4 + 3];
        const float a_hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float a_lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        float best = icp::inf();
        int slot = 0;
        const int c_end = min(n_t, (ch + 1) * len);
        for (int c = ch * len; c < c_end; ++c) {
          const float4 bh0 = bin4[c * 4], bh1 = bin4[c * 4 + 1];
          const float4 bl0 = bin4[c * 4 + 2], bl1 = bin4[c * 4 + 3];
          const float b_hi[8] = {bh0.x, bh0.y, bh0.z, bh0.w, bh1.x, bh1.y, bh1.z, bh1.w};
          const float b_lo[8] = {bl0.x, bl0.y, bl0.z, bl0.w, bl1.x, bl1.y, bl1.z, bl1.w};
          const float score = icp::score_fma(sq[c], icp::dot3_8_fma(a_hi, a_lo, b_hi, b_lo));
          if (score < best) {
            best = score;
            slot = bbase + c;
          }
        }
        part_s[it] = best;
        part_c[it] = slot;
      }
      __syncthreads();
      // ---- Merge the chunks into the running best, in slot order.
      for (int k = threadIdx.x; k < n_k; k += kThreads) {
        float best = run_s[k];
        int slot = run_c[k];
        for (int ch = 0; ch < n_ch; ++ch) {
          const float s = part_s[ch * n_k + k];
          if (s < best) {
            best = s;
            slot = part_c[ch * n_k + k];
          }
        }
        run_s[k] = best;
        run_c[k] = slot;
      }
      __syncthreads();  // bin, sq and part are rewritten by the next tile
    }

    // ---- Weight; w and u over qh.
    for (int k = threadIdx.x; k < n_k; k += kThreads) {
      icp::Match mt;
      mt.best = run_s[k];
      mt.slot = run_c[k];
      const float* q = meta + k * kMeta;
      mt.sq_q = q[3];
      mt.valid = q[4];
      const float w = icp::match_weight(mt, weighted, robust, delta);
      const float* f = bins_b + mt.slot * 8;
      float* o = wu + k * 9;
      o[0] = q[0];
      o[1] = q[1];
      o[2] = q[2];
      o[3] = 1.0f;
      o[4] = f[0];
      o[5] = f[1];
      o[6] = f[2];
      o[7] = 1.0f;
      o[8] = w;
    }
    __syncthreads();

    // ---- P's entries: lane takes the kept queries of rank = lane mod 32.
    for (int k = (lane - n_done) & 31; k < n_k; k += 32) {
      const float* o = wu + k * 9;
#pragma unroll
      for (int j = 0; j < kEntries; ++j) {
        const int e = warp + kWarps * j;
        if (e < 36) acc[j] = __fmaf_rn(__fmul_rn(o[kPairJ[e]], o[8]), o[kPairL[e]], acc[j]);
      }
    }
    n_done += n_k;
    __syncthreads();  // keep, qh and meta are rewritten by the next tile
  }

  float* Pb = P + static_cast<size_t>(b) * 64;
#pragma unroll
  for (int j = 0; j < kEntries; ++j) {
    const int e = warp + kWarps * j;
    if (e >= 36) continue;  // uniform in the warp
    float s = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    if (lane == 0) {
      Pb[kPairJ[e] * 8 + kPairL[e]] = s;
      Pb[kPairL[e] * 8 + kPairJ[e]] = s;
    }
  }
}

}  // namespace

extern "C" int icp_bin_point_moments(const float* mg, const float* qvalid,
                                     const float* reps, const float* bins_c,
                                     const float* sq_b_masked, const float* G,
                                     const float* b_row, const float* scal,
                                     int n_r, int cq, int cb, int weighted,
                                     int robust, float* P, void* stream) {
  const size_t smem = smem_floats(tiles(cq, cb)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_point_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0) {
    bin_point_moments_kernel<<<n_r, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, scal, cq, cb,
        weighted, robust, P);
  }
  return static_cast<int>(cudaGetLastError());
}
