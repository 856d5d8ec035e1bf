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
// plain unsigned max and does not depend on the order of the joins. An empty
// slot packs to 0.
//
// One cooperative launch of one kernel, over scratch words that are 0 when a
// call starts and when it ends:
//   phase A: one 64-bit atomicMax per in-range lane into the scratch words;
//   grid.sync();
//   phase B: per slot, join the scratch word with the packed image slot (a
//     plain max, so the image is read once and never scattered), unpack the
//     word into the two int32 outputs, and write the scratch word back to 0
//     if a lane touched it.
// A null image is an all-empty image: phase B then only unpacks. The wrapper
// owns the scratch (one zeroed buffer per device and stream, grown to the
// largest S seen); the kernel clears every word it used, so no call needs a
// fill. Clearing only the touched words matters: at S = 2^19 and W = 2^18
// about 60% of the words stay 0, and rewriting them made the kernel 1.5x
// slower on the H100 (tools/launch_variants.py). The grid is at most the
// blocks that fit on the card at once (occupancy x SMs, queried once per
// device), as a cooperative launch requires; grid-stride loops cover the
// rest. A launch the card refuses returns its error, and the wrapper raises:
// there is no other path.
//
// Bound: bytes. The lanes are read once (12 B each), the image once and the
// result written once (8 B per slot each way); the scratch words (8 B per
// slot, read once, cleared where touched) stay in the 50 MB L2 at the main
// path's sizes. The TPU kernel's (W x S) one-hot grid is replaced by W
// atomics and one pass over the slots.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

struct ScatterArgs {
  const int32_t* img_ssn;  // null: every slot empty
  const int32_t* img_pos;
  const int32_t* key;
  const int32_t* ssn;
  const int32_t* pos;
  unsigned long long* packed;
  int32_t* out_ssn;
  int32_t* out_pos;
  long long s;
  long long w;
};

__device__ __forceinline__ unsigned long long pack(int32_t ssn, int32_t pos) {
  const unsigned long long hi = static_cast<unsigned long long>((long long)ssn + 1);
  const unsigned long long lo = static_cast<unsigned long long>((long long)INT32_MAX - pos);
  return (hi << 32) | (lo & 0xffffffffULL);
}

constexpr int kScatterThreads = 1024;

__global__ void __launch_bounds__(kScatterThreads) scatter_max_kernel(ScatterArgs a) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = first; i < a.w; i += stride) {
    const int k = a.key[i];
    if (k < 0 || k >= a.s) continue;
    atomicMax(a.packed + k, pack(a.ssn[i], a.pos[i]));
  }
  cooperative_groups::this_grid().sync();  // orders the atomics before phase B
  for (long long i = first; i < a.s; i += stride) {
    unsigned long long p = __ldcg(a.packed + i);  // the atomics' result, from L2
    if (p != 0ULL) a.packed[i] = 0ULL;
    if (a.img_ssn != nullptr) {
      const unsigned long long q = pack(a.img_ssn[i], a.img_pos[i]);
      p = q > p ? q : p;
    }
    a.out_ssn[i] = static_cast<int32_t>(static_cast<long long>(p >> 32) - 1);
    a.out_pos[i] = static_cast<int32_t>((long long)INT32_MAX -
                                        static_cast<long long>(p & 0xffffffffULL));
  }
}

}  // namespace

// img_ssn / img_pos: (s,) int32, or both null for an all-empty image.
// scratch: at least s int64 words, all 0; they are 0 again when the kernel
// ends. out: (2, s) int32, the winning ssn row then the winning pos row.
extern "C" int repro_ssn_scatter_max(const void* img_ssn, const void* img_pos,
                                     long long s, const void* key,
                                     const void* ssn, const void* pos,
                                     long long w, void* scratch, void* out,
                                     int device, void* stream) {
  if (s <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  static int grid_of[64] = {0};
  const void* kernel = reinterpret_cast<const void*>(scatter_max_kernel);
  int max_blocks = 0;
  const cudaError_t e = coop_blocks(kernel, kScatterThreads, device, grid_of, &max_blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  ScatterArgs a;
  a.img_ssn = static_cast<const int32_t*>(img_ssn);
  a.img_pos = static_cast<const int32_t*>(img_pos);
  a.key = static_cast<const int32_t*>(key);
  a.ssn = static_cast<const int32_t*>(ssn);
  a.pos = static_cast<const int32_t*>(pos);
  a.packed = static_cast<unsigned long long*>(scratch);
  a.out_ssn = static_cast<int32_t*>(out);
  a.out_pos = a.out_ssn + s;
  a.s = s;
  a.w = w;
  const long long need = ((s > w ? s : w) + kScatterThreads - 1) / kScatterThreads;
  void* args[] = {&a};
  return launch_cooperative(kernel, need < max_blocks ? need : max_blocks, kScatterThreads, args,
                            static_cast<cudaStream_t>(stream));
}
