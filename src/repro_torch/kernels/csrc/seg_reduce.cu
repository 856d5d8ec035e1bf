// seg_reduce: the batched-OCC segmented max/min, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/batch_occ.py::seg_reduce
// (pallas_call at batch_occ.py:149). The main path reaches it through
// repro_torch.kernels.ops.occ_seg_reduce from db/batch.py::_first_writer
// (op "min", first-writer position per written row) and ::_base_ssns
// (op "max", base SSN per transaction) on rounds the fused round declines.
//
// Computes out[k] = max (or min) of val[i] over the items with key[i] == k.
// A slot with no member keeps the identity: -1 for max, INT32_MAX
// (NO_WRITER) for min. Items whose key lies outside [0, n_slots), such as
// the pad key -1, are skipped.
//
// Bound: bytes. Each item is read once (8 B) and each slot is written twice
// (the identity fill, then the result, 4 B each); there is about one integer
// operation per item, far below the card's operation rate. The TPU kernel
// evaluates a (W x S) one-hot compare grid to stay vector-shaped; on Hopper
// the scatter is done by int32 atomics that resolve in L2, so the work is
// O(W + S) and each byte crosses HBM about once. Max and min are
// order-independent, so the result does not depend on the atomics' order.

#include "common.cuh"

namespace {

template <bool kMin>
__global__ void seg_reduce_kernel(const int32_t* __restrict__ key,
                                  const int32_t* __restrict__ val, long long w,
                                  int32_t* __restrict__ out, int n_slots) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < w;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = key[i];
    if (k < 0 || k >= n_slots) continue;
    if (kMin) {
      atomicMin(out + k, val[i]);
    } else {
      atomicMax(out + k, val[i]);
    }
  }
}

}  // namespace

extern "C" int repro_seg_reduce(const void* key, const void* val, long long w,
                                void* out, int n_slots, int is_min,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  fill_i32(o, n_slots, is_min ? INT32_MAX : -1, s);
  if (w > 0 && n_slots > 0) {
    const int32_t* k = static_cast<const int32_t*>(key);
    const int32_t* v = static_cast<const int32_t*>(val);
    if (is_min) {
      seg_reduce_kernel<true><<<blocks_for(w), kThreads, 0, s>>>(k, v, w, o, n_slots);
    } else {
      seg_reduce_kernel<false><<<blocks_for(w), kThreads, 0, s>>>(k, v, w, o, n_slots);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
