// validate_sequence: the fused validate -> sequence round of the batched OCC
// executor (paper sections 4.2/4.4), hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/batch_occ.py::validate_sequence_xla
// (batch_occ.py:83), the jitted round that carries every batch of 2048 or
// more access lanes. It is not a Pallas kernel, but it is the main path's
// device pass. The main path reaches it through
// repro_torch.kernels.ops.fused_validate_sequence from
// db/batch.py::BatchOCC._fused_round.
//
// Input: one stacked (6, n_txn * k) int32 block, rows
//   0 row, 1 pos, 2 iswrite, 3 obs, 4 ssn_now, 5 locked,
// in a dense layout of n_txn transactions by k lanes, and a_len (n_txn,),
// the true access count of each transaction. Lane l of transaction t is
// valid iff l < a_len[t]. Per transaction:
//   fw[r]   = min pos over the valid write lanes of row r (INT32_MAX: none)
//   ok      = fw[row] >= pos && (obs < 0 || ssn_now == obs) && !locked
//   survive = AND of ok over the valid lanes
//   base    = max over the lanes of (valid ? ssn_now : 0)
// exactly the semantics of batch_occ.py:104-115, for every int32 pos.
//
// Design: one cooperative launch per call, with no fill.
//   The first-writer table is a scratch of int64 words that the wrapper
//   owns (one per device and stream, grown to the largest cap seen, zeroed
//   once) and an epoch that the wrapper raises before every call. A valid
//   write lane does one 64-bit atomicMax of
//       ((u64)epoch << 32) | ~flip(pos),   flip(p) = (u32)p ^ 0x80000000,
//   where flip keeps the signed order, so a larger word is a later epoch or
//   the same epoch and a smaller pos. A word whose high half is not this
//   call's epoch was left by an earlier call: it loses every atomicMax and
//   reads as no writer. So no call clears or fills the cap words (the first
//   port filled 4 MB of them per call at cap 2^20, more than a write-only
//   round's lanes). The epoch is a launch argument, so a CUDA graph would
//   replay a stale one: the wrapper refuses stream capture.
//   phase A: a grid-stride loop over the lanes, each loading iswrite,
//     a_len, row and pos at once; a valid write lane with a row in
//     [0, cap) does its atomic;
//   grid.sync();
//   phase B: one thread per lane reads its six values and a_len at once,
//     coalesced, gathers fw from the scratch (8 MB at cap 2^20,
//     L2-resident), and the lanes of a transaction, held by consecutive
//     threads, reduce survive (a warp ballot) and base (xor shuffles) when
//     k is a power of two <= 32; any other k takes one warp per
//     transaction, striding over its lanes and reducing with
//     __reduce_and_sync / __reduce_max_sync (the two forms are two
//     instantiations of the kernel; a call launches one of them).
// Both loops run whole warps (the bound is warp-uniform; threads past the
// end join the warp operations with the identities true and INT32_MIN).
// The grid is what the lanes need, capped at the blocks that fit on the
// card at once (occupancy x SMs, queried once per device), as a cooperative
// launch requires. A launch the card refuses returns its error, and the
// wrapper raises: there is no other path. tools/launch_variants.py times the
// designs not kept: the first port's three launches, a cleared int32 table
// with two barriers, phase B at one thread per transaction, and the lanes
// held in registers across the barrier. On an H100 80GB HBM3 at 700 W (chip_smoke.py) the kept
// form takes 0.0155 ms at the hybrid round's shape (2x its byte bound) and
// 0.0049 ms at the write-only round's.
//
// Bound: bytes. The lanes (24 B each) and a_len are read once and the
// outputs (5 B per transaction) written once; the atomics add 8 B per
// written row, and the gathers stay in the 50 MB L2 at the main path's
// sizes. The work is a few integer operations per lane.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

struct ValidateArgs {
  const int32_t* acc;  // (6, n_lanes)
  const int32_t* a_len;
  unsigned long long* fw;  // cap epoch-tagged first-writer words
  bool* survive;
  int32_t* bases;
  long long n_txn;
  long long n_lanes;
  int k;
  int kshift;  // log2(k) when k is a power of two <= 32, else -1
  int cap;
  unsigned int epoch;
};

constexpr int kValidateThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned int flip(int32_t p) {
  return static_cast<unsigned int>(p) ^ 0x80000000u;
}

// the first writer of row r in this call's epoch, INT32_MAX if none
__device__ __forceinline__ int32_t first_writer(const ValidateArgs& a, int r) {
  if (r < 0 || r >= a.cap) return INT32_MAX;
  const unsigned long long w = __ldcg(a.fw + r);  // the atomics' result, from L2
  if (static_cast<unsigned int>(w >> 32) != a.epoch) return INT32_MAX;
  return static_cast<int32_t>(~static_cast<unsigned int>(w) ^ 0x80000000u);
}

// The six values of lane i and its transaction's a_len, all loaded before
// any is used, so that their loads are in flight together.
struct Lane {
  int32_t len, row, pos, obs, sn, locked;
};

__device__ __forceinline__ Lane load_lane(const ValidateArgs& a, long long i, long long t) {
  const long long n = a.n_lanes;
  return Lane{a.a_len[t], a.acc[i], a.acc[n + i], a.acc[3 * n + i], a.acc[4 * n + i],
              a.acc[5 * n + i]};
}

__device__ __forceinline__ bool lane_ok(const ValidateArgs& a, const Lane& l) {
  return first_writer(a, l.row) >= l.pos && (l.obs < 0 || l.sn == l.obs) && l.locked == 0;
}

// Phase A: one epoch-tagged atomicMax per valid write lane. kShift: k is a
// power of two, so a lane's transaction is a shift, not a 64-bit division.
template <bool kShift>
__device__ __forceinline__ void first_writers(const ValidateArgs& a, long long first,
                                              long long stride) {
  const long long n = a.n_lanes;
  for (long long i = first; i < n; i += stride) {
    const long long t = kShift ? i >> a.kshift : i / a.k;
    const int32_t w = a.acc[2 * n + i], len = a.a_len[t], r = a.acc[i], p = a.acc[n + i];
    if (w == 0 || i - t * a.k >= len || r < 0 || r >= a.cap) continue;
    atomicMax(a.fw + r, (static_cast<unsigned long long>(a.epoch) << 32) | ~flip(p));
  }
}

// Phase B for k a power of two <= 32: the k lanes of a transaction are k
// consecutive threads of one warp.
__device__ __forceinline__ void reduce_groups(const ValidateArgs& a, long long first,
                                              long long stride) {
  const long long n = a.n_lanes;
  const int k = a.k, lid = threadIdx.x & 31;
  for (long long wb = first - lid; wb < n; wb += stride) {
    const long long i = wb + lid;
    const long long t = i >> a.kshift;
    bool ok = true;
    int32_t base = INT32_MIN;
    if (i < n) {
      const Lane l = load_lane(a, i, t);
      const bool valid = static_cast<int>(i & (k - 1)) < l.len;
      base = valid ? l.sn : 0;
      ok = !valid || lane_ok(a, l);
    }
    const unsigned bad = __ballot_sync(kFull, !ok);
    for (int off = k >> 1; off > 0; off >>= 1)
      base = max(base, __shfl_xor_sync(kFull, base, off, k));
    if (i < n && (lid & (k - 1)) == 0) {
      const unsigned group = k == 32 ? kFull : ((1u << k) - 1u) << lid;
      a.survive[t] = (bad & group) == 0u;
      a.bases[t] = base;
    }
  }
}

// Phase B for any other k: one warp per transaction.
__device__ __forceinline__ void reduce_warps(const ValidateArgs& a, long long first,
                                             long long stride) {
  const int lid = threadIdx.x & 31;
  for (long long t = first >> 5; t < a.n_txn; t += stride >> 5) {
    bool ok = true;
    int32_t base = INT32_MIN;
    for (int lane = lid; lane < a.k; lane += 32) {
      const Lane l = load_lane(a, t * a.k + lane, t);
      const bool valid = lane < l.len;
      base = max(base, valid ? l.sn : 0);
      ok = ok && (!valid || lane_ok(a, l));
    }
    const bool all_ok = __reduce_and_sync(kFull, ok ? 1u : 0u) != 0u;
    base = __reduce_max_sync(kFull, base);
    if (lid == 0) {
      a.survive[t] = all_ok;
      a.bases[t] = base;
    }
  }
}

// kGroups: k is a power of two <= 32 (a.kshift >= 0). The two forms are two
// kernels, so that the warp form's registers do not cut the group form's
// occupancy: ptxas gives the group form 30 registers (four blocks of 512 per
// SM) and the warp form 34; a kernel holding both needs more than 32, which
// leaves three blocks of 512 per SM.
template <bool kGroups>
__global__ void __launch_bounds__(kValidateThreads) validate_sequence_kernel(ValidateArgs a) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  first_writers<kGroups>(a, first, stride);
  cooperative_groups::this_grid().sync();  // orders the atomics before phase B
  if (kGroups)
    reduce_groups(a, first, stride);
  else
    reduce_warps(a, first, stride);
}

}  // namespace

// scratch: at least cap int64 words, each 0 or tagged with an epoch below
// `epoch` (epoch >= 1). survive: (n_txn,) bool; bases: (n_txn,) int32.
extern "C" int repro_validate_sequence(const void* acc, const void* a_len,
                                       long long n_txn, int k, int cap,
                                       void* scratch, unsigned int epoch,
                                       void* survive, void* bases,
                                       int device, void* stream) {
  if (n_txn <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  ValidateArgs a;
  a.acc = static_cast<const int32_t*>(acc);
  a.a_len = static_cast<const int32_t*>(a_len);
  a.fw = static_cast<unsigned long long*>(scratch);
  a.survive = static_cast<bool*>(survive);
  a.bases = static_cast<int32_t*>(bases);
  a.n_txn = n_txn;
  a.n_lanes = n_txn * k;
  a.k = k;
  a.kshift = -1;
  if (k <= 32 && (k & (k - 1)) == 0) a.kshift = __builtin_ctz(static_cast<unsigned>(k));
  a.cap = cap;
  a.epoch = epoch;
  static int grid_of[2][64] = {{0}};
  const bool groups = a.kshift >= 0;
  const void* kernel = groups ? reinterpret_cast<const void*>(validate_sequence_kernel<true>)
                              : reinterpret_cast<const void*>(validate_sequence_kernel<false>);
  int max_blocks = 0;
  const cudaError_t e = coop_blocks(kernel, kValidateThreads, device, grid_of[groups], &max_blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  // phase B's warp-per-transaction form needs a warp for each transaction
  const long long threads = groups || k > 32 ? a.n_lanes : 32 * n_txn;
  const long long need = (threads + kValidateThreads - 1) / kValidateThreads;
  void* args[] = {&a};
  return launch_cooperative(kernel, need < max_blocks ? need : max_blocks, kValidateThreads,
                            args, static_cast<cudaStream_t>(stream));
}
