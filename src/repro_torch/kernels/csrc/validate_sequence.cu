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
// valid iff l < a_len[t].
//   Pass 1: fw[cap] := NO_WRITER (INT32_MAX).
//   Pass 2: one thread per lane; a valid write lane does atomicMin(fw[row], pos).
//   Pass 3: one thread per transaction over its k lanes:
//     ok      = fw[row] >= pos && (obs < 0 || ssn_now == obs) && !locked
//     survive = AND of ok over the valid lanes
//     base    = max over the lanes of (valid ? ssn_now : 0)
// exactly the semantics of batch_occ.py:104-115.
//
// Bound: bytes. The 24 B of each lane are read once or twice (pass 2 reads
// row, pos and iswrite; pass 3 reads all six rows), fw is written twice and
// gathered once per valid lane, and the outputs are 5 B per transaction. The
// work is a few integer operations per lane. Pass 3 runs one thread per
// transaction, so its reads are strided by k; that is simple and right, and
// a warp-per-transaction layout is the obvious next step when k > 1.

#include "common.cuh"

namespace {

__global__ void first_writer_kernel(const int32_t* __restrict__ acc,
                                    const int32_t* __restrict__ a_len,
                                    long long n_lanes, int k, int cap,
                                    int32_t* __restrict__ fw) {
  const int32_t* row = acc;
  const int32_t* pos = acc + n_lanes;
  const int32_t* iswrite = acc + 2 * n_lanes;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_lanes;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / k;
    const int lane = static_cast<int>(i - t * k);
    if (iswrite[i] == 0 || lane >= a_len[t]) continue;
    const int r = row[i];
    if (r < 0 || r >= cap) continue;
    atomicMin(fw + r, pos[i]);
  }
}

__global__ void survive_base_kernel(const int32_t* __restrict__ acc,
                                    const int32_t* __restrict__ a_len,
                                    long long n_txn, int k, int cap,
                                    const int32_t* __restrict__ fw,
                                    bool* __restrict__ survive,
                                    int32_t* __restrict__ bases) {
  const long long n_lanes = n_txn * k;
  const int32_t* row = acc;
  const int32_t* pos = acc + n_lanes;
  const int32_t* obs = acc + 3 * n_lanes;
  const int32_t* ssn_now = acc + 4 * n_lanes;
  const int32_t* locked = acc + 5 * n_lanes;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n_txn;
       t += (long long)gridDim.x * blockDim.x) {
    const int len = a_len[t];
    bool ok_all = true;
    int32_t base = INT32_MIN;
    for (int lane = 0; lane < k; ++lane) {
      const long long i = t * k + lane;
      const int32_t sn = ssn_now[i];
      if (lane < len) {
        const int r = row[i];
        const int32_t f = (r >= 0 && r < cap) ? fw[r] : INT32_MAX;
        const int32_t o = obs[i];
        const bool ok = f >= pos[i] && (o < 0 || sn == o) && locked[i] == 0;
        ok_all = ok_all && ok;
        base = max(base, sn);
      } else {
        base = max(base, 0);
      }
    }
    survive[t] = ok_all;
    bases[t] = base;
  }
}

}  // namespace

extern "C" int repro_validate_sequence(const void* acc, const void* a_len,
                                       long long n_txn, int k, int cap,
                                       void* fw, void* survive, void* bases,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_lanes = n_txn * k;
  int32_t* fw_ = static_cast<int32_t*>(fw);
  const int32_t* acc_ = static_cast<const int32_t*>(acc);
  const int32_t* len_ = static_cast<const int32_t*>(a_len);
  if (n_txn > 0 && k > 0) {
    fill_i32(fw_, cap, INT32_MAX, st);
    first_writer_kernel<<<blocks_for(n_lanes), kThreads, 0, st>>>(
        acc_, len_, n_lanes, k, cap, fw_);
    survive_base_kernel<<<blocks_for(n_txn), kThreads, 0, st>>>(
        acc_, len_, n_txn, k, cap, fw_, static_cast<bool*>(survive),
        static_cast<int32_t*>(bases));
  }
  return static_cast<int>(cudaGetLastError());
}
