// The per-bin search of K3 (bin_point_moments.cu) and K7 (bin_gn_moments.cu),
// on live pairs only: one block of kThreads threads per bin.
//
// For each query slot i of bin b (the JAX package's _score_core /
// _search_core, icp_tpu/kernels/fused_step.py:449-517):
//   qc  = p @ G + (b_row - rep_b)                 (icp::prep_query)
//   s_c = sq_b[b, c] - 2 dot3(qc * w8, rows[b, c, 0:8])   (+inf on bad slots)
//   c*  = first argmin_c s_c
// with the scores of common.cuh's dot3_8_fma / score_fma, bit for bit the
// twins' (fused_step.search_ref).
//
// - Only live pairs are searched. The block finds the bin's last slot whose
//   masked |b|^2 is not +inf (or NaN) and searches no slot past it; in each
//   query tile it keeps the slots with qvalid != 0 (an order-keeping ballot
//   compaction). Both skips are exact: +inf and NaN never win a strict <
//   against a best that starts at +inf, and a dropped slot's weight is 0, so
//   its terms of the moments are exact zeros.
// - Shared memory is bounded whatever the capacities: the block walks the
//   query slots in tiles of up to kQTile and the bin in tiles of up to kBTile
//   slots (at the main path's shapes, cq <= 256 and cb <= 512, each is one
//   tile and the bin is staged once). The bin is staged as bf16 halves
//   [c][hi0..7 | lo0..7] beside its masked |b|^2 row. Each kept query is
//   prepared once, into shared memory.
// - The work items are (chunk of bin slots, kept query): at least kCs slots
//   a chunk and at most kPart items a tile, so the (best, slot) table stays
//   bounded. They spread over all the threads whatever cq and cb are;
//   neighbouring threads take neighbouring queries of one chunk and read its
//   slots at one address (a broadcast). Each item keeps a running strict-<
//   minimum; the chunks, then the bin tiles, merge in slot order with strict
//   <, which is the first minimum.
// - After each query tile's search the caller writes a row of `row` floats
//   per kept query (emit), and reduces them (reduce) before the next tile.
//   A reduction that gives lane l the kept queries of rank l mod 32 (rank
//   among the bin's kept queries, n_done + k) sums in the untiled order.
#pragma once

#include "common.cuh"

namespace icp {
namespace live {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = kThreads;  // query slots per tile, a multiple of 32
constexpr int kBTile = 512;       // bin slots per staged tile
constexpr int kCs = 16;           // least bin slots per search item
constexpr int kPart = 2048;       // most (best, slot) entries per tile
constexpr int kMeta = 5;          // per kept query: qc_xyz, |qc|^2_w, valid

// Tile sizes for capacities (cq, cb).
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

// Floats per kept query of the query area: its bf16 halves (16), later the
// caller's row; a multiple of 4, for the halves' 16-byte loads.
__host__ __device__ inline int query_floats(int row) {
  return row > 16 ? (row + 3) / 4 * 4 : 16;
}

// Floats of dynamic shared memory for capacities (cq, cb) and a caller's
// row of `row` floats.
__host__ __device__ inline size_t smem_floats(const Tiles& t, int row) {
  return static_cast<size_t>(t.bt) * 17                              // bin halves, |b|^2
         + static_cast<size_t>(t.qt) * (query_floats(row) + kMeta + 3)  // query area, meta,
                                                                      // running (best, slot), keep
         + static_cast<size_t>(t.part) * 2;                           // per-item (best, slot)
}

// The 36 (j, l), j <= l, entries of a symmetric 8x8 moment (K3's P, K7's
// P), then the 28 of a symmetric 7x7 block (K7's P_z): the entries the warps
// of a block share out.
static __constant__ unsigned char kPairJ[64] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 3,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 6, 6, 7,
    0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 4, 5, 5, 6};
static __constant__ unsigned char kPairL[64] = {
    0, 1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5, 6, 7, 2, 3, 4, 5, 6, 7, 3,
    4, 5, 6, 7, 4, 5, 6, 7, 5, 6, 7, 6, 7, 7,
    0, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6, 2, 3, 4, 5, 6, 3, 4, 5, 6,
    4, 5, 6, 5, 6, 6};

// What the search found for one kept query.
struct Kept {
  int q;         // its query slot in the bin
  float qc[3];   // transformed, rep-centered xyz
  float sq_q;    // |qc|^2_w
  float valid;   // qvalid * (|p_xyz|_1 > 0)
  float best;    // min_c s_c, +inf if the bin has no live slot
  int slot;      // first argmin
};

// Searches bin blockIdx.x's kept queries against its live slots. mg_b: the
// bin's cq query rows (row stride ld_mg); qv_b: their qvalid; rows_b: its cb
// rows (row stride ld_b, lanes 0:8 searched); sq_bb: its masked |b|^2; rep:
// its representative (8). emit(kept, out) writes the row of a kept query of
// the tile to out (row floats, the k-th at k * row); reduce(table, n_k, n_done) then
// reads the tile's n_k rows (stride row), n_done kept queries coming before
// them. Called by all kThreads threads of the block.
template <class Emit, class Reduce>
__device__ __forceinline__ void search_bin(
    const float* __restrict__ mg_b, int ld_mg, const float* __restrict__ qv_b,
    const float* __restrict__ rows_b, int ld_b, const float* __restrict__ sq_bb,
    const float* __restrict__ G, const float* __restrict__ b_row,
    const float* __restrict__ rep, float alpha, int cq, int cb, int row,
    float* smem, Emit emit, Reduce reduce) {
  const Tiles t = tiles(cq, cb);
  float* bin = smem;                            // [bt][16]
  float* qh = bin + t.bt * 16;                  // [qt][query_floats]: halves, then rows
  float* sq = qh + t.qt * query_floats(row);    // [bt]
  float* meta = sq + t.bt;                      // [qt][kMeta]
  float* run_s = meta + t.qt * kMeta;           // [qt] best over the earlier bin tiles
  int* run_c = reinterpret_cast<int*>(run_s + t.qt);
  int* keep = run_c + t.qt;                     // [qt] kept slots of the query tile
  float* part_s = reinterpret_cast<float*>(keep + t.qt);  // [part]
  int* part_c = reinterpret_cast<int*>(part_s + t.part);
  __shared__ float g[64];
  __shared__ float off[8];
  __shared__ int warp_n[kWarps];
  __shared__ int last_live;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // The bin's slots [base, base + n) into bin and sq, by the whole block.
  auto stage = [&](int base, int n) {
    for (int i = threadIdx.x; i < n * 8; i += kThreads) {
      const int c = i >> 3, k = i & 7;
      bf16_split(rows_b[(base + c) * ld_b + k], bin[c * 16 + k], bin[c * 16 + 8 + k]);
    }
    for (int c = threadIdx.x; c < n; c += kThreads) sq[c] = sq_bb[base + c];
  };

  // ---- The bin's last live slot.
  if (threadIdx.x == 0) last_live = -1;
  if (threadIdx.x < 64) g[threadIdx.x] = G[threadIdx.x];
  if (threadIdx.x < 8) off[threadIdx.x] = __fsub_rn(b_row[threadIdx.x], rep[threadIdx.x]);
  int my_last = -1;
  for (int c = threadIdx.x; c < cb; c += kThreads) {
    if (sq_bb[c] < inf()) my_last = c;  // false for +inf and NaN
  }
  __syncthreads();  // last_live = -1 is visible
  if (my_last >= 0) atomicMax(&last_live, my_last);
  __syncthreads();
  const int n_live = last_live + 1;
  const bool one_tile = n_live <= t.bt;
  if (one_tile) stage(0, n_live);

  const float w8[8] = {1.0f, 1.0f, 1.0f, 0.0f, alpha, alpha, alpha, 0.0f};
  const float4* bin4 = reinterpret_cast<const float4*>(bin);
  const int qf = query_floats(row);
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

    // ---- Each kept query: transform, center, weight, split.
    for (int k = threadIdx.x; k < n_k; k += kThreads) {
      const float* src = mg_b + static_cast<size_t>(keep[k]) * ld_mg;
      float p[8], qc[8], hi[8], lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = src[j];
      float* mt = meta + k * kMeta;
      prep_query(p, qv_b[keep[k]], g, off, w8, qc, hi, lo, mt[3], mt[4]);
      float4* dst = reinterpret_cast<float4*>(qh + k * qf);
      dst[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      dst[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
      dst[2] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      dst[3] = make_float4(lo[4], lo[5], lo[6], lo[7]);
      mt[0] = qc[0];
      mt[1] = qc[1];
      mt[2] = qc[2];
      run_s[k] = inf();
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
        const float4* q4 = reinterpret_cast<const float4*>(qh + k * qf);
        const float4 h0 = q4[0], h1 = q4[1], l0 = q4[2], l1 = q4[3];
        const float a_hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const float a_lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        float best = inf();
        int slot = 0;
        const int c_end = min(n_t, (ch + 1) * len);
        for (int c = ch * len; c < c_end; ++c) {
          const float4 bh0 = bin4[c * 4], bh1 = bin4[c * 4 + 1];
          const float4 bl0 = bin4[c * 4 + 2], bl1 = bin4[c * 4 + 3];
          const float b_hi[8] = {bh0.x, bh0.y, bh0.z, bh0.w, bh1.x, bh1.y, bh1.z, bh1.w};
          const float b_lo[8] = {bl0.x, bl0.y, bl0.z, bl0.w, bl1.x, bl1.y, bl1.z, bl1.w};
          const float score = score_fma(sq[c], dot3_8_fma(a_hi, a_lo, b_hi, b_lo));
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

    // ---- The caller's rows over the query area, then its reduction.
    for (int k = threadIdx.x; k < n_k; k += kThreads) {
      const float* q = meta + k * kMeta;
      const Kept kq{keep[k], {q[0], q[1], q[2]}, q[3], q[4], run_s[k], run_c[k]};
      emit(kq, qh + k * row);
    }
    __syncthreads();
    reduce(static_cast<const float*>(qh), n_k, n_done);
    n_done += n_k;
    __syncthreads();  // keep, qh and meta are rewritten by the next tile
  }
}

}  // namespace live
}  // namespace icp
