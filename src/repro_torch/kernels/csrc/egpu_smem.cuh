// The dynamic shared-memory limit of a kernel, raised once per device.
//
// A launch may use more than 48 KB of dynamic shared memory only after
// cudaFuncSetAttribute has raised the kernel's limit on the current
// device. Each kernel keeps one SmemLimit (a function-local static): the
// first launch above the limit on a device raises it to that size, and a
// launch that fits the limit already raised costs one cudaGetDevice.
#pragma once
#include <mutex>
#include <cuda_runtime.h>

namespace egpu {

constexpr int kStaticSmem = 48 * 1024;   // dynamic shared memory without opt-in
constexpr int kMaxDevices = 64;

class SmemLimit {
 public:
  // Allow ``bytes`` of dynamic shared memory for ``func`` on the current
  // device.
  cudaError_t allow(const void* func, int bytes) {
    if (bytes <= kStaticSmem) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if (bytes > allowed_[dev]) {
      err = cudaFuncSetAttribute(
          func, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      allowed_[dev] = bytes;
    }
    return cudaSuccess;
  }

 private:
  std::mutex mu_;
  int allowed_[kMaxDevices] = {};
};

}  // namespace egpu
