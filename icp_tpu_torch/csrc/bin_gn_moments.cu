// K7: per-bin search + weighting + Gauss-Newton row moments (PLANE / GICP).
//
// Replaces bin_gn_moments_pallas (icp_tpu/kernels/fused_gn.py:318), whose
// body is _gn_math in its "sublane" layout (:122-283). For each bin b and
// query slot i, after common.cuh's search and weight (the same as K3's):
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
// What bounds it: the search (75 M score FMAs at n_r = 256, cq = 96,
// cb = 128) and its latency, as in K3; the rows add ~100 FLOPs per slot.
// Registers are the scarce resource: each thread keeps its moment sums in
// registers, so only the upper triangles are accumulated, 36 entries for P
// and 28 for P_z (row and column 7 of P_z are zero), 64 in all for gicp,
// as many as K3 keeps; the writer mirrors them into full 8x8 matrices.
//
// Design: one block per bin, 128 threads, one query slot per thread; the
// bin is staged in shared memory by stage_bin (lanes 0:8 of the 12-wide
// rows), the winner's row is read once from device memory. The query rows
// and the moving normals take a row stride, so the two halves of the
// 11-wide grouped (moving8 | normal) table are read in place. The
// reduction is common.cuh's fixed-order block sum: P repeats bitwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPlane = 0, kPlaneSym = 1, kGicp = 2;

// Position of (j, l), j <= l, in the row-major upper triangle of an n x n.
__host__ __device__ constexpr int tri(int n, int j, int l) {
  return j * n - j * (j - 1) / 2 + (l - j);
}

// acc[tri(8, j, l)] += (v_j * wr) * v_l over the upper triangle.
__device__ __forceinline__ void add_row(float* acc, const float v[8], float wr) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float vw = v[j] * wr;
#pragma unroll
    for (int l = j; l < 8; ++l) acc[tri(8, j, l)] = fmaf(vw, v[l], acc[tri(8, j, l)]);
  }
}

// v = [u, m x u, u . d, 1].
__device__ __forceinline__ void gn_row(const float m[3], const float d[3],
                                       float ux, float uy, float uz, float v[8]) {
  v[0] = ux;
  v[1] = uy;
  v[2] = uz;
  v[3] = m[1] * uz - m[2] * uy;
  v[4] = m[2] * ux - m[0] * uz;
  v[5] = m[0] * uy - m[1] * ux;
  v[6] = d[0] * ux + d[1] * uy + d[2] * uz;
  v[7] = 1.0f;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int kP = 36;                        // upper triangle of P
  constexpr int kAcc = MODE == kGicp ? 64 : kP;  // + 28 of P_z's 7 x 7
  extern __shared__ float smem[];
  __shared__ float g[64];
  __shared__ float off[8];
  __shared__ float red[kWarps * kAcc];
  __shared__ float sums[kAcc];

  const int b = blockIdx.x;
  const float* bins_b = bins_vals + static_cast<size_t>(b) * cb * 12;
  const icp::BinStage bin =
      icp::stage_bin(smem, bins_b, 12, sq_b + static_cast<size_t>(b) * cb, cb);
  if (threadIdx.x < 64) g[threadIdx.x] = G[threadIdx.x];
  if (threadIdx.x < 8) {
    off[threadIdx.x] = __fsub_rn(b_row[threadIdx.x], reps[b * 8 + threadIdx.x]);
  }
  __syncthreads();

  const float alpha = scal[0];
  const float delta = scal[1];
  const float e = 1.0f - scal[2];
  const float w8[8] = {1.0f, 1.0f, 1.0f, 0.0f, alpha, alpha, alpha, 0.0f};
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

  for (int i = threadIdx.x; i < cq; i += blockDim.x) {
    const size_t slot = static_cast<size_t>(b) * cq + i;
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = mg[slot * ld_mg + k];
    const icp::Match mt = icp::search(p, qvalid[slot], g, off, w8, bin, cb);
    const float w = icp::match_weight(mt, weighted, robust, delta);
    const float* f = bins_b + mt.slot * 12;
    const float m[3] = {mt.qc[0], mt.qc[1], mt.qc[2]};
    const float d[3] = {m[0] - f[0], m[1] - f[1], m[2] - f[2]};
    const float nfx = f[8], nfy = f[9], nfz = f[10];
    float v[8];
    if constexpr (MODE == kPlane) {
      gn_row(m, d, nfx, nfy, nfz, v);
      add_row(acc, v, w);
    } else {
      const float nmx = nm[slot * ld_nm], nmy = nm[slot * ld_nm + 1],
                  nmz = nm[slot * ld_nm + 2];
      gn_row(m, d, nfx + nmx, nfy + nmy, nfz + nmz, v);
      if constexpr (MODE == kPlaneSym) {
        add_row(acc, v, w);
      } else {
        const float c = nfx * nmx + nfy * nmy + nfz * nmz;
        const float gs = e / (4.0f * (2.0f - e * (1.0f + c)));
        const float gt = e / (4.0f * (2.0f - e * (1.0f - c)));
        add_row(acc, v, w * gs);
        gn_row(m, d, nfx - nmx, nfy - nmy, nfz - nmz, v);
        add_row(acc, v, w * gt);
        const float z[7] = {m[0], m[1], m[2], d[0], d[1], d[2], 1.0f};
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          const float zw = z[j] * w;
#pragma unroll
          for (int l = j; l < 7; ++l) {
            acc[kP + tri(7, j, l)] = fmaf(zw, z[l], acc[kP + tri(7, j, l)]);
          }
        }
      }
    }
  }
  icp::block_sum<kAcc>(acc, red, sums);
  __syncthreads();
  if (threadIdx.x < 64) {
    const int j = threadIdx.x >> 3, l = threadIdx.x & 7;
    const int lo = j < l ? j : l, hi = j < l ? l : j;
    P[static_cast<size_t>(b) * 64 + threadIdx.x] = sums[tri(8, lo, hi)];
    if constexpr (MODE == kGicp) {
      Pz[static_cast<size_t>(b) * 64 + threadIdx.x] =
          hi < 7 ? sums[kP + tri(7, lo, hi)] : 0.0f;
    }
  }
}

template <int MODE>
int launch(const float* mg, int ld_mg, const float* nm, int ld_nm,
           const float* qvalid, const float* reps, const float* bins_vals,
           const float* sq_b, const float* G, const float* b_row,
           const float* scal, int n_r, int cq, int cb, int weighted, int robust,
           float* P, float* Pz, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cb) * 17 * sizeof(float);
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
