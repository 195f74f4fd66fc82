// The device of one C entry point's launches, for that call alone.  Each
// entry point takes the device of its tensors and must launch there, but
// the caller's current device is the caller's: a launch on cuda:1 from a
// thread working on cuda:0 must leave cuda:0 current.  The guard saves the
// current device, sets the target, and sets the saved one back when it goes
// out of scope, so on every return path, the error returns included.  The
// kernels bind without PyTorch's headers, so c10::cuda::CUDAGuard is not
// available here.
#pragma once

#include <cuda_runtime.h>

namespace {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&saved_);
    if (err_ != cudaSuccess) return;
    err_ = cudaSetDevice(device);
    restore_ = err_ == cudaSuccess && saved_ != device;
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(saved_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess once the target device is current.
  cudaError_t error() const { return err_; }

 private:
  int saved_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace
