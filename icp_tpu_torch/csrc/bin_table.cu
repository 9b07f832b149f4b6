// K2: padded bin table, gathered from the unsorted row sources.
//
// Replaces bin_table_pallas (icp_tpu/kernels/table_build.py:79) and covers
// the call site of its windowed twin bin_table_windowed_pallas (:150), which
// exists only because the TPU's VMEM cannot hold the sorted rows at the 16x
// shape; here every thread reads device memory directly. With the row
// sources s_0, s_1, s_2 (up to three, their lanes side by side) and the
// bin-major permutation order (null: the rows are already in that order):
//   out[b, c, :] = cat(s)[order[starts[b] + c], :]   if starts[b] + c < m
//                = 0.0                               otherwise
// A pure copy, bit-exact against bin_table_ref of the gathered,
// concatenated rows. The gather replaces the caller's torch.cat and
// index_select: one pass over the rows instead of three.
//
// What bounds it: memory traffic, the table written (n_r * capacity * d *
// 4 bytes), the rows read once, order and starts (1.4 MB at the flagship
// query table, 256 x 96 x 8, with its 16384 rows: 0.4 us of HBM
// bandwidth, so in practice its launch and its chain of dependent loads,
// starts -> order -> row).
//
// Design: one thread per output slot, bin blockIdx.x and slot blockIdx.y *
// 128 + threadIdx.x: no division. It reads order once, then walks its row's
// lanes source by source in output order into a [128][width] tile in shared
// memory; the block's 128 slots, one contiguous run of the table, then
// leave on consecutive addresses, as 16-byte vectors where the width is a
// multiple of 4 (on the card this beat one thread writing its own row as
// 16-byte vectors at 16x; at the flagship the two are within 5 %).
// 32-bit offsets: the wrapper refuses a table or a source of 2^31 elements
// or more.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSources = 3;

struct Sources {
  const float* p[kMaxSources];
  int ld[kMaxSources];  // row stride in floats
  int d[kMaxSources];   // lanes (0: absent)
};

// The source row of slot c of bin b, or -1 past the last row.
__device__ __forceinline__ int source_row(const int* order, const int* starts, int m,
                                          int b, int c) {
  const int pos = starts[b] + c;
  if (pos < 0 || pos >= m) return -1;
  return order != nullptr ? order[pos] : pos;
}

__global__ void __launch_bounds__(kThreads)
bin_table_kernel(Sources src, const int* __restrict__ order,
                 const int* __restrict__ starts, int m, int capacity, int width,
                 float* __restrict__ out) {
  extern __shared__ float tile[];  // [kThreads][width]
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kThreads;
  const int n = min(kThreads, capacity - c0);
  if (static_cast<int>(threadIdx.x) < n) {
    float* t = tile + threadIdx.x * width;
    const int r = source_row(order, starts, m, b, c0 + threadIdx.x);
    if (r < 0) {
      for (int l = 0; l < width; ++l) t[l] = 0.0f;
    } else {
#pragma unroll
      for (int s = 0; s < kMaxSources; ++s) {
        const float* row = src.p[s] + r * src.ld[s];
        for (int j = 0; j < src.d[s]; ++j) *t++ = __ldg(row + j);
      }
    }
  }
  __syncthreads();
  float* o = out + (b * capacity + c0) * width;
  if (width % 4 == 0) {  // the run starts on a 16-byte boundary
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = threadIdx.x; i < n * width / 4; i += kThreads) o4[i] = t4[i];
  } else {
    for (int i = threadIdx.x; i < n * width; i += kThreads) o[i] = tile[i];
  }
}

}  // namespace

extern "C" int icp_bin_table(const float* s0, int ld0, int d0, const float* s1,
                             int ld1, int d1, const float* s2, int ld2, int d2,
                             const int* order, const int* starts, int m, int n_r,
                             int capacity, float* out, void* stream) {
  const Sources src{{s0, s1, s2}, {ld0, ld1, ld2}, {d0, d1, d2}};
  const int width = d0 + d1 + d2;
  if (n_r <= 0 || capacity <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(n_r, (capacity + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(kThreads) * width * sizeof(float);
  if (smem > static_cast<size_t>(icp::smem_optin())) {
    return icp::launch_limit(
        "bin_table (%d, %d, %d): rows of %d lanes need %zu bytes of shared memory a block, "
        "over the card's %d", n_r, capacity, width, width, smem, icp::smem_optin());
  }
  if (grid.y > static_cast<unsigned>(icp::kMaxGridY)) {
    return icp::launch_limit(
        "bin_table (%d, %d, %d): %u tiles of %d slots, over the grid's second dimension %d",
        n_r, capacity, width, grid.y, kThreads, icp::kMaxGridY);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_table_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, order, starts, m, capacity, width, out);
  return static_cast<int>(cudaGetLastError());
}
