// K7: per-bin search + weighting + Gauss-Newton row moments (PLANE / GICP).
//
// Replaces bin_gn_moments_pallas (icp_tpu/kernels/fused_gn.py:318), whose
// body is _gn_math in its "sublane" layout (:122-283). For each bin b and
// query slot i, after K3's search and weight:
//   f = bins_vals[b, c*]: centered xyz in lanes 0:3, fixed normal n_f in 8:11
//   m = qc_xyz,  d = m - f_xyz,  n_m = the grouped, rotated moving normal
//   row(u) = v = [u, m x u, u . d, 1]        with a per-row weight factor g
//     plane:      one row,  u = n_f,          g = 1
//     plane_sym:  one row,  u = n_f + n_m,    g = 1
//     gicp:       two rows, u = n_f + n_m,    g = e / (4 (2 - e (1 + c)))
//                           u = n_f - n_m,    g = e / (4 (2 - e (1 - c)))
//                 with e = 1 - eps, c = n_f . n_m
//   P_b   = sum_i sum_rows (w g) v v^T                              (8 x 8)
//   gicp also: P_z = sum_i w z z^T, z = [m, d, 1, 0]  (the isotropic I/2
//   term, expanded outside the kernel by fused_gn.gicp_const_moment)
//
// What bounds it: the search, as in K3: ~30 FP32 instructions per live pair
// (valid query slots x live slots of their bin); the rows add ~100 FLOPs per
// kept query.
//
// Design: K3's (bin_point_moments.cu). One block of 256 threads per bin runs
// bin_search_phase.cuh's search, the same code as K3's: live pairs only,
// bounded query and bin tiles, (chunk, query) items over all threads, the
// first minimum. Then each kept query reads its winner's row of bins_vals
// (12 wide) and its moving normal (row stride ld_nm, so the two halves of
// the 11-wide grouped (moving8 | normal) table are read in place), and
// writes its rows to shared memory:
//   plane, plane_sym:  v (8) and w                       (9 floats)
//   gicp:              v_s, v_t (8 each), w g_s, w g_t, z (7) and w   (26)
// No thread holds an 8x8 accumulator: the warps take the distinct entries,
// the 36 of the symmetric P (plus the 28 of P_z's 7x7 block for gicp; its
// row and column 7 are zero), and lane l sums the kept queries whose rank
// among the bin's kept queries is l mod 32, in rank order across the query
// tiles; then a fixed shuffle tree, mirrored into both triangles. P and P_z
// repeat bitwise from run to run. alpha, delta and eps are read on the
// device (scal).
#include "bin_search_phase.cuh"

namespace {

using icp::live::kPairJ;
using icp::live::kPairL;
using icp::live::kThreads;
using icp::live::kWarps;
constexpr int kPlane = 0, kPlaneSym = 1, kGicp = 2;

template <int MODE>
struct Layout {
  static constexpr int kRow = MODE == kGicp ? 26 : 9;  // floats per kept query
  static constexpr int kN = MODE == kGicp ? 64 : 36;   // distinct entries
  static constexpr int kEntries = (kN + kWarps - 1) / kWarps;  // per warp
};

// v = [u, m x u, u . d, 1].
__device__ __forceinline__ void gn_row(const float m[3], const float d[3],
                                       float ux, float uy, float uz, float* v) {
  v[0] = ux;
  v[1] = uy;
  v[2] = uz;
  v[3] = m[1] * uz - m[2] * uy;
  v[4] = m[2] * ux - m[0] * uz;
  v[5] = m[0] * uy - m[1] * ux;
  v[6] = d[0] * ux + d[1] * uy + d[2] * uz;
  v[7] = 1.0f;
}

// Two blocks per SM: at most 128 registers a thread.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
bin_gn_moments_kernel(const float* __restrict__ mg, int ld_mg,
                      const float* __restrict__ nm, int ld_nm,
                      const float* __restrict__ qvalid,
                      const float* __restrict__ reps,
                      const float* __restrict__ bins_vals,
                      const float* __restrict__ sq_b,
                      const float* __restrict__ G,
                      const float* __restrict__ b_row,
                      const float* __restrict__ scal, int cq, int cb,
                      int weighted, int robust, float* __restrict__ P,
                      float* __restrict__ Pz) {
  using L = Layout<MODE>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* bins_b = bins_vals + static_cast<size_t>(b) * cb * 12;
  const float delta = scal[1];
  const float e = 1.0f - scal[2];
  float acc[L::kEntries];
#pragma unroll
  for (int j = 0; j < L::kEntries; ++j) acc[j] = 0.0f;

  icp::live::search_bin(
      mg + static_cast<size_t>(b) * cq * ld_mg, ld_mg, qvalid + static_cast<size_t>(b) * cq,
      bins_b, 12, sq_b + static_cast<size_t>(b) * cb, G, b_row, reps + b * 8, scal[0],
      cq, cb, L::kRow, smem,
      // ---- Weight; the GN rows.
      [&](const icp::live::Kept& q, float* o) {
        const float w = icp::match_weight(q.best, q.sq_q, q.valid, weighted, robust, delta);
        const float* f = bins_b + q.slot * 12;
        const float d[3] = {q.qc[0] - f[0], q.qc[1] - f[1], q.qc[2] - f[2]};
        const float nfx = f[8], nfy = f[9], nfz = f[10];
        if constexpr (MODE == kPlane) {
          gn_row(q.qc, d, nfx, nfy, nfz, o);
          o[8] = w;
        } else {
          const float* n = nm + (static_cast<size_t>(b) * cq + q.q) * ld_nm;
          const float nmx = n[0], nmy = n[1], nmz = n[2];
          gn_row(q.qc, d, nfx + nmx, nfy + nmy, nfz + nmz, o);
          if constexpr (MODE == kPlaneSym) {
            o[8] = w;
          } else {
            const float c = nfx * nmx + nfy * nmy + nfz * nmz;
            const float gs = e / (4.0f * (2.0f - e * (1.0f + c)));
            const float gt = e / (4.0f * (2.0f - e * (1.0f - c)));
            gn_row(q.qc, d, nfx - nmx, nfy - nmy, nfz - nmz, o + 8);
            o[16] = w * gs;
            o[17] = w * gt;
            o[18] = q.qc[0];
            o[19] = q.qc[1];
            o[20] = q.qc[2];
            o[21] = d[0];
            o[22] = d[1];
            o[23] = d[2];
            o[24] = 1.0f;
            o[25] = w;
          }
        }
      },
      // ---- The entries: lane takes the kept queries of rank = lane mod 32.
      [&](const float* rows, int n_k, int n_done) {
        for (int k = (lane - n_done) & 31; k < n_k; k += 32) {
          const float* o = rows + k * L::kRow;
#pragma unroll
          for (int j = 0; j < L::kEntries; ++j) {
            const int en = warp + kWarps * j;
            if (en >= L::kN) continue;  // uniform in the warp
            const int J = kPairJ[en], K = kPairL[en];
            if constexpr (MODE != kGicp) {
              acc[j] = __fmaf_rn(__fmul_rn(o[J], o[8]), o[K], acc[j]);
            } else if (en < 36) {
              acc[j] = __fmaf_rn(__fmul_rn(o[J], o[16]), o[K], acc[j]);
              acc[j] = __fmaf_rn(__fmul_rn(o[8 + J], o[17]), o[8 + K], acc[j]);
            } else {
              acc[j] = __fmaf_rn(__fmul_rn(o[18 + J], o[25]), o[18 + K], acc[j]);
            }
          }
        }
      });

  float* Pb = P + static_cast<size_t>(b) * 64;
#pragma unroll
  for (int j = 0; j < L::kEntries; ++j) {
    const int en = warp + kWarps * j;
    if (en >= L::kN) continue;  // uniform in the warp
    float s = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    if (lane == 0) {
      float* out = en < 36 ? Pb : Pz + static_cast<size_t>(b) * 64;
      out[kPairJ[en] * 8 + kPairL[en]] = s;
      out[kPairL[en] * 8 + kPairJ[en]] = s;
    }
  }
  if constexpr (MODE == kGicp) {  // P_z's row and column 7
    if (threadIdx.x < 16) {
      const int l = threadIdx.x & 7;
      Pz[static_cast<size_t>(b) * 64 + (threadIdx.x < 8 ? 56 + l : l * 8 + 7)] = 0.0f;
    }
  }
}

template <int MODE>
int launch(const float* mg, int ld_mg, const float* nm, int ld_nm,
           const float* qvalid, const float* reps, const float* bins_vals,
           const float* sq_b, const float* G, const float* b_row,
           const float* scal, int n_r, int cq, int cb, int weighted, int robust,
           float* P, float* Pz, cudaStream_t stream) {
  const size_t smem =
      icp::live::smem_floats(icp::live::tiles(cq, cb), Layout<MODE>::kRow) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_gn_moments_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_r > 0) {
    bin_gn_moments_kernel<MODE><<<n_r, kThreads, smem, stream>>>(
        mg, ld_mg, nm, ld_nm, qvalid, reps, bins_vals, sq_b, G, b_row, scal, cq,
        cb, weighted, robust, P, Pz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 plane, 1 plane_sym, 2 gicp (Pz written only for gicp; nm unread
// for plane).
extern "C" int icp_bin_gn_moments(const float* mg, int ld_mg, const float* nm,
                                  int ld_nm, const float* qvalid,
                                  const float* reps, const float* bins_vals,
                                  const float* sq_b_masked, const float* G,
                                  const float* b_row, const float* scal,
                                  int n_r, int cq, int cb, int mode,
                                  int weighted, int robust, float* P,
                                  float* Pz, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlane:
      return launch<kPlane>(mg, ld_mg, nm, ld_nm, qvalid, reps, bins_vals,
                            sq_b_masked, G, b_row, scal, n_r, cq, cb, weighted,
                            robust, P, Pz, s);
    case kPlaneSym:
      return launch<kPlaneSym>(mg, ld_mg, nm, ld_nm, qvalid, reps, bins_vals,
                               sq_b_masked, G, b_row, scal, n_r, cq, cb,
                               weighted, robust, P, Pz, s);
    case kGicp:
      return launch<kGicp>(mg, ld_mg, nm, ld_nm, qvalid, reps, bins_vals,
                           sq_b_masked, G, b_row, scal, n_r, cq, cb, weighted,
                           robust, P, Pz, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
