// K6: exact brute-force nearest neighbour, a 3xTF32 tensor-core filter with
// an exact re-score.
//
// Replaces brute_nn_pallas (icp_tpu/kernels/brute_nn.py:69). For each
// metric-weighted query qw[i] (8 floats) it returns
//   idx[i]   = argmin_j s_ij,  s_ij = sq_db[j] - 2 * qw[i] . db[j]   (first minimum)
//   score[i] = that minimum
// over the whole (n, 8) database, where qw[i] . db[j] is the float32 lane-order
// sum with one rounding per multiply and per add (the TPU kernel's HIGHEST
// precision), so the outputs are bitwise those of the plain twin
// brute_nn_ref. An FMA would change those bits (a float32 x float32 product
// is not exact), so a CUDA-core sweep pays ~18 unfused instructions per pair:
// 0.144 ms at 16384 x 16384 on an H100, whatever the loop.
//
// What bounds it: the tensor cores and the epilogue. At 16384 x 16384 the
// filter is 3 x 2 x 8 flops per pair on the tensor cores (1.3e10, 0.026 ms at
// the TF32 peak) and ~3 float32 instructions per pair beside it (0.024 ms).
// The reads are tiny (the 0.5 MB database stays in L2).
//
// Design.
// 1. Approximate score on the tensor cores. Each float32 x splits into
//    hi = tf32_rna(x) and lo = tf32_rna(x - hi) (x - hi is exact). Then
//    acc = lo_q.hi_b + hi_q.lo_b + hi_q.hi_b is three
//    mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, smallest terms first; the K
//    of 8 is the points' 8 lanes. s~ = fmaf(-2, acc, sq_db[j]).
// 2. A proven margin eps_i with |s~_ij - s_ij| <= eps_i for every j (below):
//    brute_margin_kernel reduces max_j |db_jk| and max_j |sq_db_j| in one
//    block, and each thread forms its queries' eps_i from them in the
//    prologue. tests/test_torch_brute_margin.py states the same formula in
//    PyTorch and holds it to an emulation of this score.
// 3. Exact re-score. A pair is re-scored in lane-order float32, exactly as the
//    twin scores it, iff NOT (s~_ij > U_i + eps_i), where U_i is any value with
//    U_i >= min_j s_ij. That is exact: a skipped pair has
//    s_ij >= s~_ij - eps_i > U_i >= min_j s_ij, so it can neither win nor tie;
//    the winner and every pair tied with it are re-scored. A thread meets its
//    rows in rising order, so a strict < keeps the first minimum of what it
//    re-scored; the threads' minima merge by (score, index): the first
//    minimum overall, the TPU kernel's tie-break. Valid U_i: +inf; any exact
//    score s_ij; and m~ + eps_i for any approximate score m~ = s~_ij (since
//    s_ij <= s~_ij + eps_i). A pilot over the first kPilot stages computes
//    the approximate minimum m~_i, so the sweep starts from U_i = m~_i +
//    eps_i; every re-score lowers U_i, and the 16 threads of a query pool
//    their U_i every kShareEvery stages (quad shuffles, then shared memory
//    across the database splits). Without the pilot, each of them would
//    re-score its own run of record minima. An inf or NaN eps_i makes every
//    pair a candidate: right, and slow.
//
// The margin. u = 2^-24; A_i = sum_k |qw_ik| M_k with M_k = max_j |db_jk|
// (so sum_k |qw_ik db_jk| <= A_i); S = max_j |sq_db_j|. For one pair:
//  (a) the twin's own rounding: the lane-order sum errs by at most
//      gamma_8 A_i (8 roundings), 2c is exact and the subtraction rounds
//      once: |s - s_exact| <= u S + (2 gamma_8 + 2u (1 + gamma_8)) A_i
//      <= u S + 18.01 u A_i;
//  (b) the split: q = hi + lo + d with |lo| <= 2^-11 |q| (1 + 2^-11) and
//      |d| <= 2^-22 |q|, likewise for b; the dropped terms lo.lo + q.d_b +
//      d_q.b - d_q.d_b sum to at most 3.01 * 2^-22 A_i, doubled in s:
//      24.1 u A_i;
//  (c) the tensor cores' accumulation, which is not IEEE-ordered. Modelled
//      conservatively: each mma truncates each of its 9 terms (C and 8
//      exact products) and its result once, each by less than 2^-23 of the
//      sum of the terms' magnitudes (<= 1.002 A_i for each of the three
//      mma, using no benefit from the ordering): 3 x 10 x 2^-23 x 1.002 A_i,
//      doubled in s: 120.2 u A_i;
//  (d) s~'s own rounding: u (S + 2.01 A_i).
//  Total |s~ - s| <= 2 u S + 164.4 u A_i. The threshold U + eps rounds once
//  and the pilot's m~ + eps once more, each by at most u (S + 2.01 A_i +
//  2 eps): 4.1 u A_i and 2 u S more, so eps must exceed 4 u S + 168.5 u A_i.
//  With eps_i = kappa 2^-20 (S + 2 A_i) = 16 kappa u S + 32 kappa u A_i this
//  needs kappa >= 168.5 / 32 = 5.27; kappa = 6 (brute_nn.py: KAPPA). A floor
//  of 2^-100 covers products that flush to zero below float32's normal range.
//
// Layout. A block of 16 warps holds 128 queries: warp w takes the 32 queries
// of group w % 4 (two m16 tiles, whose A fragments, hi and lo, stay in
// registers for the whole sweep) against database split w / 4 (a quarter of
// each staged tile), so each staged B fragment serves two m16 tiles. The
// database streams through shared memory in stages of 256 rows, in order
// from the first, double-buffered: while the block searches one stage,
// thread r < 256 copies row r of the next one and its |b|^2 with cp.async
// (zeros and sq = +inf past n), waits for its own copies and splits its row
// into hi / lo B fragments in the order mma.sync reads them ({hi(b0),
// hi(b1), lo(b0), lo(b1)} per (n8 tile, lane): one 16-byte load per thread
// per n8 tile, in register pairs). One barrier a stage. Any m and n: query
// rows past m get eps 0 and U = -inf (never candidates, never written);
// database rows past n are never re-scored.
//
// PERF.md records its times against the bound and what holds it back.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 4;                       // query groups of 32 per block
constexpr int kSplits = kWarps / kGroups;        // database splits per block
constexpr int kQueries = kGroups * 32;           // queries per block
constexpr int kStage = 256;                      // database rows per stage
constexpr int kTiles = kStage / 8;               // n8 tiles per stage
constexpr int kWarpTiles = kTiles / kSplits;     // n8 tiles per warp per stage
constexpr int kPass = 4;                         // n8 tiles per filter pass
constexpr int kPilot = 1;                        // stages of the pilot sweep
constexpr int kShareEvery = 2;                   // stages between U exchanges
static_assert(kWarpTiles % kPass == 0, "whole filter passes per stage");
static_assert(kPass == 4, "the candidate test reads four n8 tiles");
static_assert(kStage <= kThreads, "one thread copies and splits each row");

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ a rest below 2^-22 |x|), both tf32 values in float32 bits.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where `valid` is false
// (src is then not read).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// The calling thread's copies have landed and are visible to it.
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d = a (16 x 8, row) * b (8 x 8, col) + c on the tensor cores.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

struct Raw {
  float rows[kStage * 8];  // the rows as given, for the split and the re-score
  float sq[kStage];        // sq_db, +inf past n
};

struct Smem {
  Raw raw[2];
  uint4 frag[2][kTiles * 32];  // per (n8 tile, lane): {hi(b0), hi(b1), lo(b0), lo(b1)}
  float q[kQueries * 8];
  // Each thread's running (score, index) minimum and re-score count of its
  // four queries, touched only by the re-score.
  float best[4][kThreads];
  int bi[4][kThreads];
  int cnt[4][kThreads];
  float share_u[kSplits][kQueries];
  float share_s[kSplits][kQueries];
  int share_i[kSplits][kQueries];
  int share_c[kSplits][kQueries];
};

constexpr int kMarginThreads = 1024;

// max(a, b) of magnitudes that keeps a NaN (fmaxf would drop it, and a NaN
// must reach eps).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// ms[k] = max_j |db_jk| (k < 8) and ms[8] = max_j |sq_db_j|, by one block.
__global__ void __launch_bounds__(kMarginThreads)
brute_margin_kernel(const float* __restrict__ db, const float* __restrict__ sq_db, int n,
                    float* __restrict__ ms) {
  __shared__ float red[kMarginThreads / 32][9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // lanes (threadIdx.x & 1) * 4 + k
  float vs = 0.0f;
  for (int c = threadIdx.x; c < n * 2; c += kMarginThreads) {
    const float4 x = reinterpret_cast<const float4*>(db)[c];
    v[0] = nan_max(v[0], fabsf(x.x));
    v[1] = nan_max(v[1], fabsf(x.y));
    v[2] = nan_max(v[2], fabsf(x.z));
    v[3] = nan_max(v[3], fabsf(x.w));
  }
  for (int j = threadIdx.x; j < n; j += kMarginThreads) vs = nan_max(vs, fabsf(sq_db[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    vs = nan_max(vs, __shfl_xor_sync(0xffffffffu, vs, o));
    if (o > 1) {  // keep the lane parity: the half of the row
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = nan_max(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
    }
  }
  if (lane < 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red[warp][lane * 4 + k] = v[k];
  }
  if (lane == 0) red[warp][8] = vs;
  __syncthreads();
  if (threadIdx.x < 9) {
    float r = 0.0f;
    for (int w = 0; w < kMarginThreads / 32; ++w) r = nan_max(r, red[w][threadIdx.x]);
    ms[threadIdx.x] = r;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
brute_nn_kernel(const float* __restrict__ qw, const float* __restrict__ db,
                const float* __restrict__ sq_db, const float* __restrict__ ms,
                float kappa, float eps_floor, int m, int n, int* __restrict__ idx,
                float* __restrict__ score, int* __restrict__ rescored) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int grp = warp % kGroups, split = warp / kGroups;
  const int q0 = blockIdx.x * kQueries;

  // ---- The block's queries into shared memory (zero rows past m).
  for (int i = threadIdx.x; i < kQueries * 2; i += kThreads) {
    const int q = q0 + (i >> 1);
    reinterpret_cast<float4*>(sm.q)[i] =
        q < m ? reinterpret_cast<const float4*>(qw)[static_cast<size_t>(q0) * 2 + i]
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // Steps: the pilot's stages, then every stage, each run in order from 0.
  const int n_stages = (n + kStage - 1) / kStage;
  const int n_pilot = min(kPilot, n_stages);
  const int steps = n_pilot + n_stages;
  auto stage_of = [&](int step) { return step < n_pilot ? step : step - n_pilot; };
  // Thread r < kStage copies row r of step `step` and its |b|^2 into raw
  // buffer step & 1 (zeros and +inf past n).
  auto copy_row = [&](int step) {
    if (threadIdx.x >= kStage) return;
    Raw& buf = sm.raw[step & 1];
    const int r = threadIdx.x, row = stage_of(step) * kStage + r;
    const float* src = db + static_cast<size_t>(row < n ? row : 0) * 8;
    copy16(buf.rows + r * 8, src, row < n);
    copy16(buf.rows + r * 8 + 4, src + 4, row < n);
    if (row < n) {
      copy4(buf.sq + r, sq_db + row);
    } else {
      buf.sq[r] = icp::inf();
    }
  };
  // Then, once its copies have landed, splits its row into B fragments:
  // item (row r, lane pair k) holds b0 = lane k and b1 = lane k + 4 of
  // fragment lane (r % 8) * 4 + k of n8 tile r / 8. The stage is the
  // block's after the next barrier.
  auto split_row = [&](int step) {
    if (threadIdx.x >= kStage) return;
    copies_landed();
    const int r = threadIdx.x;
    const float* x = sm.raw[step & 1].rows + r * 8;
    uint4* frag = sm.frag[step & 1] + (r >> 3) * 32 + (r & 7) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint4 v;
      tf32_split(x[k], v.x, v.z);
      tf32_split(x[k + 4], v.y, v.w);
      frag[k] = v;
    }
  };
  copy_row(0);
  split_row(0);
  __syncthreads();

  // ---- Per thread: 4 queries (two m16 tiles x rows g, g + 8).
  int ql[4];
  float e[4], u[4], thr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ql[j] = grp * 32 + (j >> 1) * 16 + (j & 1) * 8 + g;
    // eps = kappa (S + 2 sum_k |qw_k| M_k) + eps_floor, kappa = KAPPA 2^-20.
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) a = __fmaf_rn(fabsf(sm.q[ql[j] * 8 + k]), ms[k], a);
    e[j] = q0 + ql[j] < m ? __fmaf_rn(2.0f * kappa, a, __fmaf_rn(kappa, ms[8], eps_floor)) : 0.0f;
    u[j] = icp::inf();  // the pilot's approximate minimum
    thr[j] = icp::inf();
    sm.best[j][threadIdx.x] = icp::inf();
    sm.bi[j][threadIdx.x] = 0;
    sm.cnt[j][threadIdx.x] = 0;
  }
  uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const int row = grp * 32 + mt * 16 + (r & 1) * 8 + g;
      tf32_split(sm.q[row * 8 + t + (r >> 1) * 4], a_hi[mt][r], a_lo[mt][r]);
    }
  }

  for (int step = 0; step < steps; ++step) {
    const bool pilot = step < n_pilot;
    const int st = stage_of(step);
    const Raw& sg = sm.raw[step & 1];
    const uint4* frag = sm.frag[step & 1];
    if (step + 1 < steps) copy_row(step + 1);  // into the buffer step - 1 used

#pragma unroll
    for (int c0 = split * kWarpTiles; c0 < (split + 1) * kWarpTiles; c0 += kPass) {
      float s[kPass][8];  // slot mt * 4 + r: query mt * 2 + r / 2, column 2t + r % 2
#pragma unroll
      for (int x = 0; x < kPass; ++x) {
        const uint4 f = frag[(c0 + x) * 32 + lane];
        const float2 sq2 = reinterpret_cast<const float2*>(sg.sq)[(c0 + x) * 4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float acc[4];
          mma_tf32(acc, a_lo[mt], f.x, f.y, zero);  // lo . hi
          mma_tf32(acc, a_hi[mt], f.z, f.w, acc);   // hi . lo
          mma_tf32(acc, a_hi[mt], f.x, f.y, acc);   // hi . hi
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[x][mt * 4 + r] = __fmaf_rn(-2.0f, acc[r], (r & 1) ? sq2.y : sq2.x);
          }
        }
      }
      if (pilot) {
#pragma unroll
        for (int x = 0; x < kPass; ++x) {
#pragma unroll
          for (int k = 0; k < 8; ++k) u[k >> 1] = fminf(u[k >> 1], s[x][k]);
        }
        continue;
      }
      // Any candidate? Per query the least of its 8 scores of the pass (a
      // tree of fminf; a NaN score implies a NaN or inf eps, whose threshold
      // admits everything), against its threshold.
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mt = j >> 1, r = (j & 1) * 2;  // slots mt * 4 + r, + r + 1
        const float m0 = fminf(fminf(s[0][mt * 4 + r], s[0][mt * 4 + r + 1]),
                               fminf(s[1][mt * 4 + r], s[1][mt * 4 + r + 1]));
        const float m1 = fminf(fminf(s[2][mt * 4 + r], s[2][mt * 4 + r + 1]),
                               fminf(s[3][mt * 4 + r], s[3][mt * 4 + r + 1]));
        any |= !(fminf(m0, m1) > thr[j]);
      }
      if (!any) continue;
      unsigned mask = 0;
#pragma unroll
      for (int x = 0; x < kPass; ++x) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          mask |= static_cast<unsigned>(!(s[x][k] > thr[k >> 1])) << (x * 8 + k);
        }
      }
      while (mask) {
        const int bit = __ffs(mask) - 1;
        mask &= mask - 1;
        const int x = bit >> 3, k = bit & 7, j = k >> 1;
        const int row = (c0 + x) * 8 + 2 * t + (k & 1);  // in the stage
        const int col = st * kStage + row;
        if (col >= n) continue;
        const float4* br = reinterpret_cast<const float4*>(sg.rows + row * 8);
        const float4* qr = reinterpret_cast<const float4*>(sm.q) + (grp * 32 + (j >> 1) * 16 + (j & 1) * 8 + g) * 2;
        const float4 b0 = br[0], b1 = br[1], a0 = qr[0], a1 = qr[1];
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float cross = icp::lane_dot<8>(av, bv, 1);
        const float sc = __fsub_rn(sg.sq[row], __fmul_rn(2.0f, cross));
        ++sm.cnt[j][threadIdx.x];
        if (sc < sm.best[j][threadIdx.x]) {  // the rows rise: the first minimum
          sm.best[j][threadIdx.x] = sc;
          sm.bi[j][threadIdx.x] = col;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {  // static register indices
          if (jj == j && sc < u[jj]) {
            u[jj] = sc;
            thr[jj] = __fadd_rn(u[jj], e[jj]);
          }
        }
      }
    }

    if (step + 1 < steps) split_row(step + 1);
    const bool last_pilot = step == n_pilot - 1;
    const bool share = last_pilot || (!pilot && (step - n_pilot + 1) % kShareEvery == 0);
    if (share) {  // pool u over the quad; the splits read it after the barrier
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        u[j] = fminf(u[j], __shfl_xor_sync(0xffffffffu, u[j], 1));
        u[j] = fminf(u[j], __shfl_xor_sync(0xffffffffu, u[j], 2));
        if (t == 0) sm.share_u[split][ql[j]] = u[j];
      }
    }
    __syncthreads();
    if (share) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int sp = 0; sp < kSplits; ++sp) u[j] = fminf(u[j], sm.share_u[sp][ql[j]]);
        if (last_pilot) {  // m~ + eps bounds the minimum; rows past m never search
          u[j] = q0 + ql[j] < m ? __fadd_rn(u[j], e[j]) : -icp::inf();
        }
        thr[j] = __fadd_rn(u[j], e[j]);
      }
    }
  }

  // ---- Merge the (score, index) minima: the quad, then the splits.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float best = sm.best[j][threadIdx.x];
    int bi = sm.bi[j][threadIdx.x];
    int cnt = sm.cnt[j][threadIdx.x];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (t == 0) {
      sm.share_s[split][ql[j]] = best;
      sm.share_i[split][ql[j]] = bi;
      sm.share_c[split][ql[j]] = cnt;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kQueries; i += kThreads) {
    const int q = q0 + i;
    if (q >= m) continue;
    float b = sm.share_s[0][i];
    int k = sm.share_i[0][i];
    int c = sm.share_c[0][i];
#pragma unroll
    for (int sp = 1; sp < kSplits; ++sp) {
      const float ob = sm.share_s[sp][i];
      const int oi = sm.share_i[sp][i];
      c += sm.share_c[sp][i];
      if (ob < b || (ob == b && oi < k)) {
        b = ob;
        k = oi;
      }
    }
    idx[q] = k;
    score[q] = b;
    if (rescored != nullptr) rescored[q] = c;
  }
}

}  // namespace

// ms: (9,) scratch for the margin's maxima; kappa, eps_floor: the margin's
// constants (kernels/brute_nn.py); rescored: (m,) int or null.
extern "C" int icp_brute_nn(const float* qw, const float* db, const float* sq_db,
                            float* ms, float kappa, float eps_floor, int m, int n, int* idx,
                            float* score, int* rescored, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + kQueries - 1) / kQueries;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      brute_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0 && n > 0) {
    brute_margin_kernel<<<1, kMarginThreads, 0, s>>>(db, sq_db, n, ms);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    brute_nn_kernel<<<blocks, kThreads, smem, s>>>(qw, db, sq_db, ms, kappa, eps_floor, m,
                                                   n, idx, score, rescored);
  }
  return static_cast<int>(cudaGetLastError());
}
