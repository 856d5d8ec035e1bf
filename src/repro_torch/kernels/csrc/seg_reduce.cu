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
// the pad key -1, are skipped. Max and min are order-independent, so the
// result does not depend on the order of the atomics.
//
// Design: one cooperative launch of one kernel. Each thread fills its share
// of the slots with the identity; grid.sync(); each thread does one int32
// global atomicMin/atomicMax per item of its share, resolved in L2. The
// barrier takes the place of the kernel boundary between the identity fill
// and the scatter, which were two launches. The grid is what the larger of
// the items and the slots needs, at most the blocks that fit on the card at
// once (queried once per device); grid-stride loops cover the rest, so one
// path serves every size.
//
// A cluster of 8 blocks holding the slots in distributed shared memory was
// tried first and measured 2x to 4x slower on the H100 at the main path's
// sizes (tools/launch_variants.py): remote shared-memory atomics from 8 SMs
// are slower than L2 atomics from the whole card.
//
// Bound: bytes. Each item is read once (8 B) and each slot written once
// (4 B); there is about one integer operation per item. At the sizes of
// chip_smoke.py (2^16 items over 2^14 slots) that is 0.6 MB, about 0.2 us at
// 3.35 TB/s: less than one launch costs, so the launch, not the bytes,
// bounds the call. The TPU kernel evaluates a (W x S) one-hot compare grid
// to stay vector-shaped; here the work is O(W + S).

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kSegThreads = 512;

template <bool kMin>
__global__ void __launch_bounds__(kSegThreads)
seg_reduce_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ val, long long w,
                  int32_t* __restrict__ out, int n_slots) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int32_t identity = kMin ? INT32_MAX : -1;
  for (long long i = first; i < n_slots; i += stride) out[i] = identity;
  cooperative_groups::this_grid().sync();  // every slot filled before any atomic
  for (long long i = first; i < w; i += stride) {
    const int k = key[i];
    if (k < 0 || k >= n_slots) continue;
    if (kMin) {
      atomicMin(out + k, val[i]);
    } else {
      atomicMax(out + k, val[i]);
    }
  }
}

template <bool kMin>
int launch(const int32_t* key, const int32_t* val, long long w, int32_t* out, int n_slots,
           int device, cudaStream_t stream) {
  static int grid_of[64] = {0};
  const void* kernel = reinterpret_cast<const void*>(seg_reduce_kernel<kMin>);
  int max_blocks = 0;
  const cudaError_t e = coop_blocks(kernel, kSegThreads, device, grid_of, &max_blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = ((w > n_slots ? w : n_slots) + kSegThreads - 1) / kSegThreads;
  void* args[] = {&key, &val, &w, &out, &n_slots};
  return launch_cooperative(kernel, need < max_blocks ? need : max_blocks, kSegThreads, args,
                            stream);
}

}  // namespace

extern "C" int repro_seg_reduce(const void* key, const void* val, long long w,
                                void* out, int n_slots, int is_min, int device,
                                void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const int32_t* k = static_cast<const int32_t*>(key);
  const int32_t* v = static_cast<const int32_t*>(val);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_min ? launch<true>(k, v, w, o, n_slots, device, s)
                : launch<false>(k, v, w, o, n_slots, device, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
