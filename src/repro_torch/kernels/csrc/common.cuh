// Shared launch helpers for the OLTP kernels (one copy per translation unit).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Enough blocks to cover n elements one per thread, capped so a grid-stride
// loop covers the rest (132 SMs x 16 resident blocks of 256 threads).
constexpr long long kMaxBlocks = 132LL * 16;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

__global__ void fill_i32_kernel(int32_t* __restrict__ out, long long n, int32_t v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = v;
  }
}

inline void fill_i32(int32_t* out, long long n, int32_t v, cudaStream_t stream) {
  if (n > 0) fill_i32_kernel<<<blocks_for(n), kThreads, 0, stream>>>(out, n, v);
}

}  // namespace
