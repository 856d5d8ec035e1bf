// rwkv6_chunked: the wkv6 recurrence of the RWKV6 ("Finch") prefill in block
// form, from a zero state, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6.py::rwkv6_chunked
// (rwkv6.py:89, pallas_call at rwkv6.py:124), whose body (rwkv6.py:39-86) it
// computes chunk by chunk (32 steps). With lw = cumsum(log(max(w, 1e-30)))
// over the chunk and lx = lw - log(max(w, 1e-30)):
//   y_t    = (r_t * exp(lx_t)) . S_prev + sum_s A[t][s] v_s
//   A[t,s] = sum_k r_tk k_sk exp(lx_tk - lw_sk)   (s < t)
//   A[t,t] = sum_k r_tk u_k k_tk
//   S_new  = diag(exp(lw_last)) S_prev + sum_s (k_s * exp(lw_last - lw_s))^T v_s
// Every exponent is a later-minus-earlier difference of log-cumsums, so it is
// <= 0 under any decay; the factored exp(lw) * exp(-lw) form would overflow.
// The main path reaches it through repro_torch.models.rwkv.time_mix with no
// carried state (every prefill layer of an rwkv model).
//
// Design: one block per (batch * head, slice of 32 value columns), 256
// threads; the TPU grid's sequential chunk axis becomes a loop inside the
// block. The value columns are independent given the chunk's r, k and decays,
// so the slices need no communication; each block keeps its (K, 32) slice of
// the state in shared memory in fp32 and recomputes the chunk's (32, 32)
// matrix A. Per chunk it stages r, k, v and log w in shared memory, takes the
// cumulative sum with one thread per key channel, forms the lower triangle
// and diagonal of A (528 entries laid out densely over the threads, so no
// lane idles above the diagonal), scales r and k by their decays in place,
// then writes y and updates the state. A chunk that runs past S is masked:
// its tail steps get r = k = v = 0 and log-decay 0, which leaves y and the
// state exactly unchanged, so any S is taken.
//
// Layout: any strides for (batch, head, position) of r, k, v, w and y; the
// last dim of each must be contiguous. The model passes its (B, S, H, K)
// activations as (B, H, S, K) views. r, k and v are float32 or bfloat16 (one
// type), w and u float32; y has v's type, the final state (B, H, K, V) is
// float32. K and V are at most 64.
//
// Bound: bytes. r, k, v, w and y are B*H*S*64 elements each; the block form
// does about 350 flops and 17 exps per element of r (at C = 32, K = V = 64),
// all from registers and shared memory: 23.8 GFLOP at B = 8, H = 64,
// S = 2048, 0.36 ms at 67 TFLOP/s fp32, against 1.35 GB or 0.40 ms of bytes
// at 3.35 TB/s (fp32 inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kChunk = 32;
constexpr int kKMax = 64;
constexpr int kVMax = 64;
constexpr int kVB = 32;                      // value columns per block
constexpr int kTri = kChunk * (kChunk + 1) / 2;
constexpr int kThreadsWkv = 256;

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* y;
  float* state;
  long long b, h, s, kd, vd;
  long long rsb, rsh, rss, ksb, ksh, kss, vsb, vsh, vss, wsb, wsh, wss, ysb, ysh, yss;
};

// Rows padded to kKMax + 1: a warp that reads one column of many rows hits 32
// different banks.
struct WkvSmem {
  float r[kChunk][kKMax + 1];    // r, then r * exp(lx)
  float k[kChunk][kKMax + 1];    // k, then k * exp(lw_last - lw)
  float lw[kChunk][kKMax + 1];   // inclusive log-cumsum
  float lx[kChunk][kKMax + 1];   // log w, then lw - log w
  float v[kChunk][kVB];
  float a[kChunk][kChunk + 1];   // lower triangle and diagonal of A
  float st[kKMax][kVB];          // this block's state slice
  float u[kKMax];
  unsigned char tri_t[kTri];     // entry e of the triangle is A[tri_t][tri_s]
  unsigned char tri_s[kTri];
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsWkv) rwkv6_chunked_kernel(const WkvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WkvSmem& sm = *reinterpret_cast<WkvSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long bi = bh / a.h, hi = bh % a.h;
  const int kd = static_cast<int>(a.kd);
  const int v0 = blockIdx.y * kVB;
  const int vb = min(kVB, static_cast<int>(a.vd) - v0);

  const T* rp = static_cast<const T*>(a.r) + bi * a.rsb + hi * a.rsh;
  const T* kp = static_cast<const T*>(a.k) + bi * a.ksb + hi * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.vsb + hi * a.vsh + v0;
  const float* wp = a.w + bi * a.wsb + hi * a.wsh;
  T* yp = static_cast<T*>(a.y) + bi * a.ysb + hi * a.ysh + v0;

  for (int e = tid; e < kd * vb; e += kThreadsWkv) sm.st[e / vb][e % vb] = 0.f;
  if (tid < kd) sm.u[tid] = a.u[hi * kd + tid];
  if (tid < kChunk) {
    const int base = tid * (tid + 1) / 2;
    for (int s = 0; s <= tid; ++s) {
      sm.tri_t[base + s] = static_cast<unsigned char>(tid);
      sm.tri_s[base + s] = static_cast<unsigned char>(s);
    }
  }

  for (long long c0 = 0; c0 < a.s; c0 += kChunk) {
    // stage the chunk: r, k, log w (K columns) and this block's v columns
    for (int e = tid; e < kChunk * kd; e += kThreadsWkv) {
      const int t = e / kd, kk = e % kd;
      const long long pos = c0 + t;
      const bool in = pos < a.s;
      sm.r[t][kk] = in ? to_f(rp[pos * a.rss + kk]) : 0.f;
      sm.k[t][kk] = in ? to_f(kp[pos * a.kss + kk]) : 0.f;
      sm.lx[t][kk] = in ? logf(fmaxf(wp[pos * a.wss + kk], 1e-30f)) : 0.f;
    }
    for (int e = tid; e < kChunk * vb; e += kThreadsWkv) {
      const int t = e / vb, vv = e % vb;
      const long long pos = c0 + t;
      sm.v[t][vv] = pos < a.s ? to_f(vp[pos * a.vss + vv]) : 0.f;
    }
    __syncthreads();
    // log-cumsums along the chunk, one thread per key channel, in order
    if (tid < kd) {
      float run = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float l = sm.lx[t][tid];
        run += l;
        sm.lw[t][tid] = run;
        sm.lx[t][tid] = run - l;
      }
    }
    __syncthreads();
    // A[t][s] for s <= t: the decayed r.k below the diagonal, r.(u*k) on it
    for (int e = tid; e < kTri; e += kThreadsWkv) {
      const int t = sm.tri_t[e], s = sm.tri_s[e];
      const bool diag = s == t;
      float acc = 0.f;
      for (int kk = 0; kk < kd; ++kk) {
        const float f = diag ? sm.u[kk] : expf(sm.lx[t][kk] - sm.lw[s][kk]);
        acc = fmaf(sm.r[t][kk] * sm.k[s][kk], f, acc);
      }
      sm.a[t][s] = acc;
    }
    __syncthreads();
    // in place: r * exp(lx) for the state term, k * exp(lw_last - lw) for
    // the state update
    for (int e = tid; e < kChunk * kd; e += kThreadsWkv) {
      const int t = e / kd, kk = e % kd;
      sm.r[t][kk] *= expf(sm.lx[t][kk]);
      sm.k[t][kk] *= expf(sm.lw[kChunk - 1][kk] - sm.lw[t][kk]);
    }
    __syncthreads();
    // y = (r * exp(lx)) . S_prev + A v
    for (int e = tid; e < kChunk * vb; e += kThreadsWkv) {
      const int t = e / vb, vv = e % vb;
      const long long pos = c0 + t;
      if (pos >= a.s) continue;
      float ys = 0.f;
      for (int kk = 0; kk < kd; ++kk) ys = fmaf(sm.r[t][kk], sm.st[kk][vv], ys);
      float yi = 0.f;
      for (int s = 0; s <= t; ++s) yi = fmaf(sm.a[t][s], sm.v[s][vv], yi);
      yp[pos * a.yss + vv] = from_f<T>(ys + yi);
    }
    __syncthreads();
    // S_new = diag(exp(lw_last)) S_prev + (k * exp(lw_last - lw))^T v
    for (int e = tid; e < kd * vb; e += kThreadsWkv) {
      const int kk = e / vb, vv = e % vb;
      float acc = 0.f;
      for (int s = 0; s < kChunk; ++s) acc = fmaf(sm.k[s][kk], sm.v[s][vv], acc);
      sm.st[kk][vv] = fmaf(expf(sm.lw[kChunk - 1][kk]), sm.st[kk][vv], acc);
    }
    __syncthreads();
  }

  for (int e = tid; e < kd * vb; e += kThreadsWkv) {
    const int kk = e / vb, vv = e % vb;
    a.state[(bh * a.kd + kk) * a.vd + v0 + vv] = sm.st[kk][vv];
  }
}

template <typename T>
int launch(const WkvArgs& a, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(WkvSmem));
  cudaError_t err = cudaFuncSetAttribute(rwkv6_chunked_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.b * a.h), static_cast<unsigned>((a.vd + kVB - 1) / kVB));
  rwkv6_chunked_kernel<T><<<grid, kThreadsWkv, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// meta: b, h, s, kd, vd, then the strides in elements (batch, head, pos) of
// r, k, v, w and y. dtype of r, k, v and y: 0 float32, 1 bfloat16. u: (h, kd)
// float32, contiguous. state: (b, h, kd, vd) float32, contiguous. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for kd or vd outside [1, 64] or
// an unknown dtype.
extern "C" int repro_rwkv6_chunked(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, void* y, void* state, const long long* meta,
                                   int dtype, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  WkvArgs a;
  a.r = r; a.k = k; a.v = v;
  a.w = static_cast<const float*>(w); a.u = static_cast<const float*>(u);
  a.y = y; a.state = static_cast<float*>(state);
  a.b = meta[0]; a.h = meta[1]; a.s = meta[2]; a.kd = meta[3]; a.vd = meta[4];
  a.rsb = meta[5]; a.rsh = meta[6]; a.rss = meta[7];
  a.ksb = meta[8]; a.ksh = meta[9]; a.kss = meta[10];
  a.vsb = meta[11]; a.vsh = meta[12]; a.vss = meta[13];
  a.wsb = meta[14]; a.wsh = meta[15]; a.wss = meta[16];
  a.ysb = meta[17]; a.ysh = meta[18]; a.yss = meta[19];
  if (a.kd < 1 || a.kd > kKMax || a.vd < 1 || a.vd > kVMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.b <= 0 || a.h <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
