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
//     grid.sync) and a cluster launch.
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

__global__ void fill_k(int32_t* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = -1;
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
  fill_k<<<blocks256(n), 256, 0, st>>>(out, n);
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
