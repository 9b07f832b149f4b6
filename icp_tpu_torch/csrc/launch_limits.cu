// The launch limits the entry points share (common.cuh): the reason a
// launch could not be made, and the device attributes that bound a launch,
// read once per device.
#include <atomic>
#include <cstdarg>
#include <cstdio>

#include "common.cuh"

namespace {

constexpr int kMaxDevices = 64;
std::atomic<int> g_smem_optin[kMaxDevices];
std::atomic<int> g_sm_count[kMaxDevices];
thread_local char g_message[512];

int cached(std::atomic<int>* cache, cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) {
    cudaDeviceGetAttribute(&value, attr, dev);
    return value;
  }
  value = cache[dev].load(std::memory_order_relaxed);
  if (value == 0) {
    cudaDeviceGetAttribute(&value, attr, dev);
    cache[dev].store(value, std::memory_order_relaxed);
  }
  return value;
}

}  // namespace

namespace icp {

int launch_limit(const char* fmt, ...) {
  va_list args;
  va_start(args, fmt);
  vsnprintf(g_message, sizeof(g_message), fmt, args);
  va_end(args);
  return kLaunchLimit;
}

int smem_optin() { return cached(g_smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin); }

int sm_count() { return cached(g_sm_count, cudaDevAttrMultiProcessorCount); }

}  // namespace icp

// Why the last entry point of this thread returned kLaunchLimit.
extern "C" const char* icp_launch_limit_message() { return g_message; }
