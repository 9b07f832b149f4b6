// K5: per-bin exhaustive search of the unfused RBC pipeline.
//
// Replaces bin_search_pallas (icp_tpu/kernels/bin_search.py:115). For each
// grouped query slot i of bin b, padded slots included:
//   best[b, i]    = min_c (sq_b[b, c] - 2 * dot3(qg_w[b, i], bins_c[b, c]))
//   matched[b, i] = vals[b, c*, :]         (c* the first argmin)
// dot3 is the bf16x3 score contraction of common.cuh (dot3_8_fma, bit for bit
// the plain twin bin_search_ref's lane order), so kernel and twin pick the
// same slot. The TPU kernel gathers the payload with a one-hot HIGHEST
// matmul, an exact gather; here the winner's V floats are copied. A bin with
// no live slot returns +inf and slot 0's (finite) payload, as argmin does.
//
// What bounds it: the pairs of a query slot and a live slot of its bin, 50
// fp32 operations each (three 8-lane products, two adds, the score and the
// compare), ~34 instructions. At the flagship shape (n_r = 256, cq = 96,
// cb = 128; 8 to 128 live slots a bin, 61 on average) that is 1.5 M pairs,
// a few microseconds of issue: the launch, the dependent loads, the
// barriers and the largest bins' search dominate. At n_r 16 (cq 1536, cb
// 2048; 299 to 2023 live slots a bin) it is 25 M pairs, and the largest
// bins set the time.
//
// Design:
// - Live slots only. The block finds its bin's last slot whose masked |b|^2
//   is finite (icp::live::live_slots, K3's and K7's) and searches no slot
//   past it: +inf and NaN never win a strict < against a best that starts
//   at +inf, so the cut is exact. (The count of finite slots would not do:
//   invalid database points leave +inf holes inside a bin.)
// - The grid is (bin, tile of 32 * kQ query slots), so a few large bins
//   still give many blocks. With three query slots a thread that is 256
//   blocks at every bin count of the 16384-landmark configurations (cq =
//   1.5 x 16384 / n_r, a multiple of 96); bins past one tile take one
//   query slot a thread instead, three times the blocks, which the card
//   balances over bins of very different sizes. Each thread
//   keeps kQ query slots' bf16 halves in registers; the bin is staged in
//   tiles of up to kBTile slots (icp::live::stage_slots: [c][hi0..7 |
//   lo0..7] and |b|^2), so shared memory does not grow with cq or cb. The
//   first tile is staged while the queries load, and where it holds the
//   whole bin the last-live scan reads it there. The eight warps split each
//   tile's slots, every thread of a warp reading one slot at one address (a
//   broadcast); each keeps a running strict-< minimum over its increasing
//   slots, and the warps' partial minima merge as (lower score, then lower
//   slot): the first minimum.
// - The winner's payload is copied in 16-byte vectors where V is a
//   multiple of 4 (8, 12) and both tables are 16-byte aligned.
#include <cstdint>

#include "bin_search_phase.cuh"

namespace {

constexpr int kThreads = icp::live::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBTile = 512;  // bin slots per staged tile

__host__ __device__ inline int bin_tile(int cb) { return cb < kBTile ? cb : kBTile; }

// Floats of dynamic shared memory: a staged tile, or the warps' partial
// (best, slot) pairs of the merge of 32 * kq query slots.
__host__ __device__ inline int smem_floats(int cb, int kq) {
  const int tile = bin_tile(cb) * 17;
  const int merge = 2 * kWarps * 32 * kq;
  return tile > merge ? tile : merge;
}

// kQ query slots per thread; with one, four blocks share an SM.
template <int kQ>
__global__ void __launch_bounds__(kThreads, kQ == 1 ? 4 : 2)
bin_search_kernel(const float* __restrict__ qg_w, const float* __restrict__ bins_c,
                  const float* __restrict__ sq_b, const float* __restrict__ vals,
                  int cq, int cb, int v, int vec, float* __restrict__ best_score,
                  float* __restrict__ matched) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_live;
  constexpr int kQB = 32 * kQ;  // query slots per block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int bt = bin_tile(cb);
  float* bin = smem;           // [bt][16]
  float* sq = smem + bt * 16;  // [bt]

  // The query slots, kQ per thread: slot q0 + j * 32 + lane. They are
  // split into bf16 halves after the first tile's loads are issued.
  float a_hi[kQ][8], a_lo[kQ][8], best[kQ];
  int slot[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int q = q0 + j * 32 + lane;
    const float* row = qg_w + (static_cast<size_t>(b) * cq + q) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) a_hi[j][k] = q < cq ? row[k] : 0.0f;
    best[j] = icp::inf();
    slot[j] = 0;
  }

  // The first tile is staged before the bin's last live slot is known, so
  // its loads overlap the queries'; where it holds the whole bin, the scan
  // reads its staged |b|^2.
  const float* sq_bb = sq_b + static_cast<size_t>(b) * cb;
  const float* rows_b = bins_c + static_cast<size_t>(b) * cb * 8;
  icp::live::stage_slots(rows_b, 8, sq_bb, 0, bt, bin, sq);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) icp::bf16_split(a_hi[j][k], a_hi[j][k], a_lo[j][k]);
  }
  __syncthreads();
  const int n_live = icp::live::live_slots(cb > bt ? sq_bb : sq, cb, last_live);
  const float4* bin4 = reinterpret_cast<const float4*>(bin);
  for (int base = 0; base < n_live; base += bt) {
    const int n_t = min(bt, n_live - base);
    if (base > 0) {
      __syncthreads();  // the previous tile is consumed
      icp::live::stage_slots(rows_b, 8, sq_bb, base, n_t, bin, sq);
      __syncthreads();
    }
    const int span = (n_t + kWarps - 1) / kWarps;
    const int c_end = min(n_t, (warp + 1) * span);
    for (int c = warp * span; c < c_end; ++c) {
      const float4 h0 = bin4[c * 4], h1 = bin4[c * 4 + 1];
      const float4 l0 = bin4[c * 4 + 2], l1 = bin4[c * 4 + 3];
      const float b_hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float b_lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const float sc = sq[c];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float score = icp::score_fma(sc, icp::dot3_8_fma(a_hi[j], a_lo[j], b_hi, b_lo));
        if (score < best[j]) {
          best[j] = score;
          slot[j] = base + c;
        }
      }
    }
  }

  // Merge the warps' partial minima per query slot (the staged tile is
  // free once every warp is past its search): (lower score, then lower
  // slot).
  __syncthreads();
  float* red_s = smem;  // [kWarps][kQB]
  int* red_c = reinterpret_cast<int*>(smem + kWarps * kQB);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    red_s[warp * kQB + j * 32 + lane] = best[j];
    red_c[warp * kQB + j * 32 + lane] = slot[j];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= kQB || q0 + t >= cq) return;
  float bs = red_s[t];
  int bc = red_c[t];
  for (int w = 1; w < kWarps; ++w) {
    const float s = red_s[w * kQB + t];
    const int c = red_c[w * kQB + t];
    if (s < bs || (s == bs && c < bc)) {
      bs = s;
      bc = c;
    }
  }
  const size_t out = static_cast<size_t>(b) * cq + q0 + t;
  best_score[out] = bs;
  const size_t src = (static_cast<size_t>(b) * cb + bc) * v;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(vals + src);
    float4* d4 = reinterpret_cast<float4*>(matched + out * v);
    for (int l = 0; l < v / 4; ++l) d4[l] = s4[l];
  } else {
    for (int l = 0; l < v; ++l) matched[out * v + l] = vals[src + l];
  }
}

}  // namespace

extern "C" int icp_bin_search(const float* qg_w, const float* bins_c,
                              const float* sq_b_masked, const float* vals, int n_r,
                              int cq, int cb, int v, float* best_score,
                              float* matched, void* stream) {
  const int vec = v % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(matched) % 16 == 0;
  if (n_r > 0 && cq > 0 && cb > 0) {
    // Bins past one tile are few and of very different sizes: one query
    // slot a thread gives three times the blocks.
    const int kq = cb > kBTile ? 1 : 3;
    const size_t smem = static_cast<size_t>(smem_floats(cb, kq)) * sizeof(float);
    const dim3 grid(n_r, (cq + 32 * kq - 1) / (32 * kq));
    if (grid.y > static_cast<unsigned>(icp::kMaxGridY)) {
      return icp::launch_limit(
          "bin_search (%d, %d, %d): %u query tiles of %d, over the grid's second dimension %d",
          n_r, cq, cb, grid.y, 32 * kq, icp::kMaxGridY);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kq == 1) {
      bin_search_kernel<1><<<grid, kThreads, smem, st>>>(
          qg_w, bins_c, sq_b_masked, vals, cq, cb, v, vec, best_score, matched);
    } else {
      bin_search_kernel<3><<<grid, kThreads, smem, st>>>(
          qg_w, bins_c, sq_b_masked, vals, cq, cb, v, vec, best_score, matched);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
