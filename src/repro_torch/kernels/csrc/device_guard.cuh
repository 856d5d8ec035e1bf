// The launch idiom of every C entry point: the wrapper passes the ordinal of
// its tensors' device, and the entry point makes that device current for its
// own scope only. cudaSetDevice is called only when the caller's current
// device differs, and the caller's device is restored on the way out.
#pragma once

#include <cuda_runtime.h>

namespace {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or why the device could not be made current.
  int error() const { return static_cast<int>(err_); }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace
