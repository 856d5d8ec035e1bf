// Designs of ssn_scatter_max and seg_reduce that the port measured and did
// not keep, for tools/launch_variants.py to time beside the kept kernels.
//
//   scatter_uncleared: the kept one-launch scatter, but clearing every
//     scratch word in phase B, not only the touched ones;
//   scatter_three:     the first port's three launches (pack, scatter, unpack);
//   seg_two:           the first port's two launches (identity fill, atomics);
//   seg_cluster_dist:  one 8-block cluster, block r holding slots
//     [r * per, (r + 1) * per) in shared memory, every item an atomic into
//     the owning block through distributed shared memory;
//   seg_cluster_priv:  one 8-block cluster, every block holding all slots
//     (n_slots * 4 B <= 227 KB), local shared-memory atomics, then block r
//     merges slice r of the 8 tables;
//   empty_*:           the floors of a plain, a cooperative (with one
//     grid.sync) and a cluster launch;
// and of validate_sequence (power-of-two k up to 32 only):
//   validate_three: the first port's three launches (INT32_MAX fill of cap
//     int32 words, one thread per lane with atomicMin, one thread per
//     transaction over its k lanes), copied from it;
//   validate_fill: one cooperative launch over a cleared int32 first-writer
//     table: fill, grid.sync, atomicMin, grid.sync, then the kept phase B;
//   validate_txn:  one cooperative launch, the kept epoch-tagged phase A,
//     then phase B at one thread per transaction over its k lanes;
//   validate_regs: the kept design, but each thread loads its lanes once,
//     before the barrier, and holds them in registers (at most 8 lanes a
//     thread; a larger call returns cudaErrorInvalidValue).
// Every entry point returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef unsigned long long u64;

// outside the unnamed namespace: the extern "C" entry points take it
struct Scatter {
  const int32_t *img_ssn, *img_pos, *key, *ssn, *pos;
  u64* packed;
  int32_t *out_ssn, *out_pos;
  long long s, w;
};

// validate_sequence's arguments; fw is the epoch-tagged u64 table, or the
// int32 table of validate_three and validate_fill
struct Validate {
  const int32_t *acc, *a_len;
  void* fw;
  bool* survive;
  int32_t* bases;
  long long n_txn, n_lanes;
  int k, kshift, cap;
  unsigned int epoch;
};

namespace {

__device__ __forceinline__ u64 pack(int32_t ssn, int32_t pos) {
  return ((u64)((long long)ssn + 1) << 32) | ((u64)((long long)INT32_MAX - pos) & 0xffffffffULL);
}
__device__ __forceinline__ void unpack(u64 p, int32_t* ssn, int32_t* pos) {
  *ssn = (int32_t)((long long)(p >> 32) - 1);
  *pos = (int32_t)((long long)INT32_MAX - (long long)(p & 0xffffffffULL));
}


__global__ void scatter_uncleared(Scatter a) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  for (long long i = t; i < a.w; i += nt) {
    const int k = a.key[i];
    if (k >= 0 && k < a.s) atomicMax(a.packed + k, pack(a.ssn[i], a.pos[i]));
  }
  cg::this_grid().sync();
  for (long long i = t; i < a.s; i += nt) {
    u64 p = __ldcg(a.packed + i);
    a.packed[i] = 0ULL;
    const u64 q = pack(a.img_ssn[i], a.img_pos[i]);
    unpack(q > p ? q : p, a.out_ssn + i, a.out_pos + i);
  }
}

__global__ void pack_k(Scatter a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.s;
       i += (long long)gridDim.x * blockDim.x)
    a.packed[i] = pack(a.img_ssn[i], a.img_pos[i]);
}
__global__ void scatter_k(Scatter a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.w;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = a.key[i];
    if (k >= 0 && k < a.s) atomicMax(a.packed + k, pack(a.ssn[i], a.pos[i]));
  }
}
__global__ void unpack_k(Scatter a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.s;
       i += (long long)gridDim.x * blockDim.x)
    unpack(a.packed[i], a.out_ssn + i, a.out_pos + i);
}

int blocks256(long long n) {
  const long long b = (n + 255) / 256;
  return (int)(b < 1 ? 1 : (b > 2112 ? 2112 : b));
}

__global__ void fill_k(int32_t* out, long long n, int32_t v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = v;
}
__global__ void seg_atomic_k(const int32_t* key, const int32_t* val, long long w, int32_t* out,
                             int n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < w;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = key[i];
    if (k >= 0 && k < n) atomicMax(out + k, val[i]);
  }
}

constexpr int kC = 8;

__global__ void seg_cluster_dist(const int32_t* key, const int32_t* val, long long w,
                                 int32_t* out, int n, int per) {
  extern __shared__ int32_t sl[];
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), lo = r * per, own = max(0, min(per, n - lo));
  for (int i = threadIdx.x; i < own; i += blockDim.x) sl[i] = -1;
  cl.sync();
  for (long long i = r * (long long)blockDim.x + threadIdx.x; i < w; i += (long long)kC * blockDim.x) {
    const int k = key[i];
    if (k < 0 || k >= n) continue;
    const int o = k / per;
    atomicMax(cl.map_shared_rank(sl, o) + (k - o * per), val[i]);
  }
  cl.sync();
  for (int i = threadIdx.x; i < own; i += blockDim.x) out[lo + i] = sl[i];
}

__global__ void seg_cluster_priv(const int32_t* key, const int32_t* val, long long w,
                                 int32_t* out, int n, int per) {
  extern __shared__ int32_t sl[];
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank();
  for (int i = threadIdx.x; i < n; i += blockDim.x) sl[i] = -1;
  __syncthreads();
  for (long long i = r * (long long)blockDim.x + threadIdx.x; i < w; i += (long long)kC * blockDim.x) {
    const int k = key[i];
    if (k >= 0 && k < n) atomicMax(sl + k, val[i]);
  }
  cl.sync();
  const int lo = r * per, own = max(0, min(per, n - lo));
  for (int i = threadIdx.x; i < own; i += blockDim.x) {
    int m = -1;
#pragma unroll
    for (int q = 0; q < kC; ++q) m = max(m, cl.map_shared_rank(sl, q)[lo + i]);
    out[lo + i] = m;
  }
  cl.sync();  // no block leaves while another reads its table
}

template <typename K>
int launch_cluster(K kernel, size_t smem, cudaStream_t st, const int32_t* key, const int32_t* val,
                   long long w, int32_t* out, int n, int per) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kC;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, key, val, w, out, n, per);
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegLanes = 8;

__device__ __forceinline__ u64 fw_word(unsigned int epoch, int32_t pos) {
  return ((u64)epoch << 32) | (unsigned int)~((unsigned int)pos ^ 0x80000000u);
}
// the first writer of row r: the epoch-tagged table, or the int32 one
template <bool kEpoch>
__device__ __forceinline__ int32_t fw_read(const Validate& a, int r) {
  if (r < 0 || r >= a.cap) return INT32_MAX;
  if (!kEpoch) return __ldcg((const int32_t*)a.fw + r);
  const u64 w = __ldcg((const u64*)a.fw + r);
  if ((unsigned int)(w >> 32) != a.epoch) return INT32_MAX;
  return (int32_t)(~(unsigned int)w ^ 0x80000000u);
}

// the kept phase A, on either table
template <bool kEpoch>
__device__ void phase_a(const Validate& a, long long first, long long stride) {
  const long long n = a.n_lanes;
  for (long long i = first; i < n; i += stride) {
    const int32_t w = a.acc[2 * n + i], len = a.a_len[i >> a.kshift], r = a.acc[i], p = a.acc[n + i];
    if (w == 0 || (int)(i & (a.k - 1)) >= len || r < 0 || r >= a.cap) continue;
    if (kEpoch)
      atomicMax((u64*)a.fw + r, fw_word(a.epoch, p));
    else
      atomicMin((int32_t*)a.fw + r, p);
  }
}

// the kept phase B (one thread per lane, the k lanes of a transaction on
// consecutive threads), on either table
template <bool kEpoch>
__device__ void phase_b(const Validate& a, long long first, long long stride) {
  const long long n = a.n_lanes;
  const int k = a.k, lid = threadIdx.x & 31;
  for (long long wb = first - lid; wb < n; wb += stride) {
    const long long i = wb + lid, t = i >> a.kshift;
    bool ok = true;
    int32_t base = INT32_MIN;
    if (i < n) {
      const int32_t len = a.a_len[t], row = a.acc[i], pos = a.acc[n + i], obs = a.acc[3 * n + i],
                    sn = a.acc[4 * n + i], lk = a.acc[5 * n + i];
      const bool valid = (int)(i & (k - 1)) < len;
      base = valid ? sn : 0;
      ok = !valid || (fw_read<kEpoch>(a, row) >= pos && (obs < 0 || sn == obs) && lk == 0);
    }
    const unsigned bad = __ballot_sync(kFull, !ok);
    for (int off = k >> 1; off > 0; off >>= 1) base = max(base, __shfl_xor_sync(kFull, base, off, k));
    if (i < n && (lid & (k - 1)) == 0) {
      a.survive[t] = (bad & (k == 32 ? kFull : ((1u << k) - 1u) << lid)) == 0u;
      a.bases[t] = base;
    }
  }
}

// validate_three, copied from the first port: launches 2 and 3
__global__ void three_first_writer(Validate a) {
  const int32_t *row = a.acc, *pos = a.acc + a.n_lanes, *iswrite = a.acc + 2 * a.n_lanes;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < a.n_lanes;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / a.k;
    const int lane = (int)(i - t * a.k);
    if (iswrite[i] == 0 || lane >= a.a_len[t]) continue;
    const int r = row[i];
    if (r < 0 || r >= a.cap) continue;
    atomicMin((int32_t*)a.fw + r, pos[i]);
  }
}

__global__ void three_survive_base(Validate a) {
  const long long n = a.n_lanes;
  const int32_t* fw = (const int32_t*)a.fw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < a.n_txn;
       t += (long long)gridDim.x * blockDim.x) {
    const int len = a.a_len[t];
    bool ok_all = true;
    int32_t base = INT32_MIN;
    for (int lane = 0; lane < a.k; ++lane) {
      const long long i = t * a.k + lane;
      const int32_t sn = a.acc[4 * n + i];
      if (lane < len) {
        const int r = a.acc[i];
        const int32_t f = (r >= 0 && r < a.cap) ? fw[r] : INT32_MAX;
        const int32_t o = a.acc[3 * n + i];
        ok_all = ok_all && f >= a.acc[n + i] && (o < 0 || sn == o) && a.acc[5 * n + i] == 0;
        base = max(base, sn);
      } else {
        base = max(base, 0);
      }
    }
    a.survive[t] = ok_all;
    a.bases[t] = base;
  }
}

__global__ void __launch_bounds__(512) validate_fill(Validate a) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = first; r < a.cap; r += stride) ((int32_t*)a.fw)[r] = INT32_MAX;
  cg::this_grid().sync();
  phase_a<false>(a, first, stride);
  cg::this_grid().sync();
  phase_b<false>(a, first, stride);
}

__global__ void __launch_bounds__(512) validate_txn(Validate a) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x, n = a.n_lanes;
  phase_a<true>(a, first, stride);
  cg::this_grid().sync();
  for (long long t = first; t < a.n_txn; t += stride) {
    const int len = a.a_len[t];
    bool ok = true;
    int32_t base = INT32_MIN;
    for (int l = 0; l < a.k; ++l) {
      const long long i = t * a.k + l;
      if (l < len) {
        const int32_t sn = a.acc[4 * n + i], o = a.acc[3 * n + i];
        ok = ok && fw_read<true>(a, a.acc[i]) >= a.acc[n + i] && (o < 0 || sn == o) &&
             a.acc[5 * n + i] == 0;
        base = max(base, sn);
      } else {
        base = max(base, 0);
      }
    }
    a.survive[t] = ok;
    a.bases[t] = base;
  }
}

__global__ void __launch_bounds__(512, 2) validate_regs(Validate a) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x, n = a.n_lanes;
  const int k = a.k, lid = threadIdx.x & 31;
  int32_t row[kRegLanes], pos[kRegLanes], sn[kRegLanes];
  unsigned flags = 0;  // bit 2j: lane valid; bit 2j+1: its obs and lock checks pass
#pragma unroll
  for (int j = 0; j < kRegLanes; ++j) {
    const long long i = first + j * stride;
    row[j] = pos[j] = sn[j] = 0;
    if (i >= n) continue;
    const int32_t len = a.a_len[i >> a.kshift], w = a.acc[2 * n + i], o = a.acc[3 * n + i];
    const int32_t lk = a.acc[5 * n + i];
    row[j] = a.acc[i];
    pos[j] = a.acc[n + i];
    sn[j] = a.acc[4 * n + i];
    if ((int)(i & (k - 1)) >= len) continue;
    flags |= (1u | ((o < 0 || sn[j] == o) && lk == 0 ? 2u : 0u)) << (2 * j);
    if (w != 0 && row[j] >= 0 && row[j] < a.cap)
      atomicMax((u64*)a.fw + row[j], fw_word(a.epoch, pos[j]));
  }
  cg::this_grid().sync();
#pragma unroll
  for (int j = 0; j < kRegLanes; ++j) {
    const long long i = first + j * stride, t = i >> a.kshift;
    if (i - lid >= n) break;  // warp-uniform
    bool ok = true;
    int32_t base = i < n ? 0 : INT32_MIN;
    if ((flags >> (2 * j)) & 1u) {
      base = sn[j];
      ok = ((flags >> (2 * j + 1)) & 1u) && fw_read<true>(a, row[j]) >= pos[j];
    }
    const unsigned bad = __ballot_sync(kFull, !ok);
    for (int off = k >> 1; off > 0; off >>= 1) base = max(base, __shfl_xor_sync(kFull, base, off, k));
    if (i < n && (lid & (k - 1)) == 0) {
      a.survive[t] = (bad & (k == 32 ? kFull : ((1u << k) - 1u) << lid)) == 0u;
      a.bases[t] = base;
    }
  }
}

__global__ void empty_k() {}
__global__ void empty_coop_k() { cg::this_grid().sync(); }
__global__ void empty_cluster_k() { cg::this_cluster().sync(); }

}  // namespace

// variant 0: scatter_uncleared (cooperative, 1024 threads, occupancy x SMs
// blocks); 1: scatter_three
extern "C" int variant_scatter(int variant, Scatter* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    pack_k<<<blocks256(a->s), 256, 0, st>>>(*a);
    scatter_k<<<blocks256(a->w), 256, 0, st>>>(*a);
    unpack_k<<<blocks256(a->s), 256, 0, st>>>(*a);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, scatter_uncleared, 1024, 0);
  const long long need = ((a->s > a->w ? a->s : a->w) + 1023) / 1024;
  const int grid = (int)(need < per * sms ? need : per * sms);
  void* args[] = {a};
  const cudaError_t e =
      cudaLaunchCooperativeKernel((const void*)scatter_uncleared, grid, 1024, args, 0, st);
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}

// op max. variant 0: seg_two; 1: seg_cluster_dist; 2: seg_cluster_priv
extern "C" int variant_seg(int variant, const int32_t* key, const int32_t* val, long long w,
                           int32_t* out, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int per = (n + kC - 1) / kC;
  if (variant == 1) return launch_cluster(seg_cluster_dist, (size_t)per * 4, st, key, val, w, out, n, per);
  if (variant == 2) return launch_cluster(seg_cluster_priv, (size_t)n * 4, st, key, val, w, out, n, per);
  fill_k<<<blocks256(n), 256, 0, st>>>(out, n, -1);
  seg_atomic_k<<<blocks256(w), 256, 0, st>>>(key, val, w, out, n);
  return (int)cudaGetLastError();
}

// variant 0: plain launch of one block; 1: cooperative, 132 x 1024 threads,
// one grid.sync; 2: one 8-block cluster of 1024 threads, one cluster.sync
extern "C" int variant_empty(int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    empty_k<<<1, 32, 0, st>>>();
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e = cudaLaunchCooperativeKernel((const void*)empty_coop_k, sms, 1024, nullptr, 0, st);
    const cudaError_t l = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : l);
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kC;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC);
  cfg.blockDim = dim3(1024);
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_cluster_k);
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}

// validate_sequence, power-of-two k <= 32. variant 0: validate_fill; 1:
// validate_txn; 2: validate_regs, each cooperative, 512 threads, the grid
// the lanes need (transactions for variant 1) capped at occupancy x SMs;
// 3: validate_three, plain launches of 256 threads as in the first port.
extern "C" int variant_validate(int variant, Validate* a, void* stream) {
  if (a->kshift < 0 || variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 3) {
    fill_k<<<blocks256(a->cap), 256, 0, st>>>((int32_t*)a->fw, a->cap, INT32_MAX);
    three_first_writer<<<blocks256(a->n_lanes), 256, 0, st>>>(*a);
    three_survive_base<<<blocks256(a->n_txn), 256, 0, st>>>(*a);
    return (int)cudaGetLastError();
  }
  const void* kernels[] = {(const void*)validate_fill, (const void*)validate_txn,
                           (const void*)validate_regs};
  const void* kernel = kernels[variant];
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, 512, 0);
  long long need = ((variant == 1 ? a->n_txn : a->n_lanes) + 511) / 512;
  if (variant == 0 && (a->cap + 511) / 512 > need) need = (a->cap + 511) / 512;
  const long long grid = need < (long long)per * sms ? need : (long long)per * sms;
  if (variant == 2 && a->n_lanes > grid * 512 * kRegLanes) return (int)cudaErrorInvalidValue;
  void* args[] = {a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, (unsigned)grid, 512, args, 0, st);
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}
