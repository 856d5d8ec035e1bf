// ssn_scatter_max: the SSN-guarded replay apply of recovery (paper section 5),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/scatter_max.py::ssn_scatter_max
// (pallas_call at scatter_max.py:157) and its XLA twin ssn_scatter_max_xla
// (scatter_max.py:92), which is what the reference's fused_replay_scan and
// fused_replay_apply actually ran. The main path reaches it through
// repro_torch.kernels.ops.fused_replay_scan (core/recovery.py::
// _fused_tile_winners) and ops.fused_replay_apply (replay_columnar with
// use_kernel=True, against a checkpoint image).
//
// Computes, per slot, the winner of a preloaded image (ssn, pos) and a batch
// of writes (key, ssn, pos) under the lattice "max ssn, then min pos". An
// empty slot is (-1, INT32_MAX = NO_POS); a checkpoint slot has pos -1 and so
// wins its SSN ties. Lanes whose key lies outside [0, S) are skipped: both the
// Pallas pad key -1 and the twin's overflow slot S.
//
// Design: the pair packs into one unsigned 64-bit word
//     ((u64)(ssn + 1) << 32) | (u32)(INT32_MAX - pos)
// for ssn in [-1, 2^31 - 1] and pos in [-1, 2^31 - 1]. A larger word is a
// larger ssn, or the same ssn with a smaller pos, so the lattice join is a
// plain unsigned max: one 64-bit atomicMax per lane, and the result does not
// depend on the order of the atomics. An empty slot packs to 0. Three passes:
// pack the image into the scratch words, scatter the lanes, unpack.
//
// Bound: bytes. The image is read once and the result written once (8 B per
// slot each way) and each lane is read once (12 B); the scratch words add
// 16 B per slot of traffic that mostly stays in the 50 MB L2 at the main
// path's sizes. The TPU kernel's (W x S) one-hot grid is replaced by O(W + S)
// atomics.

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned long long pack(int32_t ssn, int32_t pos) {
  const unsigned long long hi = static_cast<unsigned long long>((long long)ssn + 1);
  const unsigned long long lo = static_cast<unsigned long long>((long long)INT32_MAX - pos);
  return (hi << 32) | (lo & 0xffffffffULL);
}

__global__ void pack_kernel(const int32_t* __restrict__ img_ssn,
                            const int32_t* __restrict__ img_pos, long long s,
                            unsigned long long* __restrict__ packed) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < s;
       i += (long long)gridDim.x * blockDim.x) {
    packed[i] = pack(img_ssn[i], img_pos[i]);
  }
}

__global__ void scatter_kernel(const int32_t* __restrict__ key,
                               const int32_t* __restrict__ ssn,
                               const int32_t* __restrict__ pos, long long w,
                               unsigned long long* __restrict__ packed,
                               long long s) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < w;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = key[i];
    if (k < 0 || k >= s) continue;
    atomicMax(packed + k, pack(ssn[i], pos[i]));
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ packed,
                              long long s, int32_t* __restrict__ out_ssn,
                              int32_t* __restrict__ out_pos) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < s;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned long long p = packed[i];
    out_ssn[i] = static_cast<int32_t>(static_cast<long long>(p >> 32) - 1);
    out_pos[i] = static_cast<int32_t>((long long)INT32_MAX -
                                      static_cast<long long>(p & 0xffffffffULL));
  }
}

}  // namespace

extern "C" int repro_ssn_scatter_max(const void* img_ssn, const void* img_pos,
                                     long long s, const void* key,
                                     const void* ssn, const void* pos,
                                     long long w, void* scratch, void* out_ssn,
                                     void* out_pos, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s > 0) {
    unsigned long long* packed = static_cast<unsigned long long*>(scratch);
    pack_kernel<<<blocks_for(s), kThreads, 0, st>>>(
        static_cast<const int32_t*>(img_ssn), static_cast<const int32_t*>(img_pos),
        s, packed);
    if (w > 0) {
      scatter_kernel<<<blocks_for(w), kThreads, 0, st>>>(
          static_cast<const int32_t*>(key), static_cast<const int32_t*>(ssn),
          static_cast<const int32_t*>(pos), w, packed, s);
    }
    unpack_kernel<<<blocks_for(s), kThreads, 0, st>>>(
        packed, s, static_cast<int32_t*>(out_ssn), static_cast<int32_t*>(out_pos));
  }
  return static_cast<int>(cudaGetLastError());
}
