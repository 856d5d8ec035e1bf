// Shared launch helpers for the OLTP kernels (one copy per translation unit).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

// The blocks of `kernel`, launched with `threads` threads, that fit on
// `device` at once: the most a cooperative launch may have. `cache` keeps one
// count per device ordinal, queried on the first call for that device.
inline cudaError_t coop_blocks(const void* kernel, int threads, int device, int (&cache)[64],
                               int* blocks) {
  const bool cacheable = device >= 0 && device < 64;
  if (cacheable && cache[device] > 0) {
    *blocks = cache[device];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (cacheable) cache[device] = *blocks;
  return cudaSuccess;
}

// A cooperative launch of `kernel` on `grid` blocks, with the launch's own
// error, or else cudaGetLastError() (which it also clears).
inline int launch_cooperative(const void* kernel, long long grid, int threads, void** args,
                              cudaStream_t stream) {
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)),
                                                    dim3(threads), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace
