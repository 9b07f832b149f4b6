// K2: padded bin table from bin-major sorted rows.
//
// Replaces bin_table_pallas (icp_tpu/kernels/table_build.py:79) and covers
// the call site of its windowed twin bin_table_windowed_pallas (:150), which
// exists only because the TPU's VMEM cannot hold the sorted rows at the 16x
// shape; here every thread reads device memory directly.
//   out[b, c, l] = sorted_rows[starts[b] + c, l]   if starts[b] + c < m
//                = 0.0                             otherwise
// A pure copy, bit-exact against bin_table_ref.
//
// What bounds it: memory traffic, n_r * capacity * d * 4 bytes written and
// about as much read (0.8 MB at the flagship query table, 256 x 96 x 8):
// well under a microsecond of HBM bandwidth, so in practice its launch.
//
// Design: one thread per output element (bin, slot, lane), consecutive
// threads on consecutive lanes and slots, so each warp reads and writes
// contiguous runs (a bin's slots are a contiguous run of the sorted rows).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bin_table_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
                 int m, int d, int capacity, long long total,
                 float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int lane = static_cast<int>(idx % d);
    const long long bc = idx / d;
    const int c = static_cast<int>(bc % capacity);
    const int b = static_cast<int>(bc / capacity);
    const long long src = static_cast<long long>(starts[b]) + c;
    out[idx] = (src >= 0 && src < m) ? rows[src * d + lane] : 0.0f;
  }
}

}  // namespace

extern "C" int icp_bin_table(const float* sorted_rows, const int* starts, int m,
                             int d, int n_r, int capacity, float* out,
                             void* stream) {
  const long long total = static_cast<long long>(n_r) * capacity * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond this
  if (blocks > 0) {
    bin_table_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        sorted_rows, starts, m, d, capacity, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}
