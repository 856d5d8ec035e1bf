// ssm_scan_chunked: the Mamba-style selective scan of the LLM prefill in SSD
// block form, from a zero state, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan.py::ssm_scan_chunked
// (pallas_call at ssm_scan.py:116), whose body (ssm_scan.py:33-79) it
// computes chunk by chunk (64 steps), with u = dt * x and
// la = cumsum(log(max(a, 1e-30))) over the chunk:
//   y_t   = exp(la_t) (C_t . S_prev) + sum_{s<=t} exp(la_t - la_s) (C_t . B_s) u_s
//   S_new = exp(la_last) S_prev + sum_s exp(la_last - la_s) u_s (x) B_s
// Every exponent is a later-minus-earlier difference of log-cumsums, so it is
// <= 0. The main path reaches it through repro_torch.models.ssm.ssm_scan with
// no carried state (every prefill layer of a hybrid model).
//
// Design: one block per (batch * head, slice of 32 of the P state rows), 256
// threads. The state rows are independent given the chunk's decays and B/C,
// so the slices need no communication; each block walks the chunks in order
// (the TPU grid's sequential dimension) and keeps its (32, N) slice of the
// state in shared memory, in fp32. Per chunk it stages u, B, C and the
// log-decays in shared memory, takes the cumulative sum on one thread (the
// order torch.cumsum uses), forms the masked (64, 64) decay-weighted C.B
// matrix, then writes y and updates the state. A chunk that runs past S is
// masked: its tail steps get u = 0 and log-decay 0, which is exactly the
// reference's padding with dt = 0 and decay = 1, so any S is taken.
//
// Layout: any strides for (batch, head, position) of x, y, dt and decay and
// for (batch, position) of B and C; the last dim of x, y, B and C must be
// contiguous. The model passes its (B, S, H, P) activations as (B, H, S, P)
// views. x, B and C are float32 or bfloat16 (one type), dt and decay float32;
// y has x's type, the final state (B, H, P, N) is float32.
//
// Bound: bytes. x and y dominate (B*H*S*P elements each); the block form's
// work is a few hundred flops per element, all in registers and shared memory.

#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kChunk = 64;
constexpr int kPB = 32;      // state rows per block
constexpr int kNMax = 32;    // largest state dim N
constexpr int kThreadsSsm = 256;

struct SsmArgs {
  const void* x;
  const float* dt;
  const float* decay;
  const void* bm;
  const void* cm;
  void* y;
  float* state;
  long long b, h, s, p, n;
  long long xsb, xsh, xss, dsb, dsh, dss, asb, ash, ass;
  long long bsb, bss, csb, css, ysb, ysh, yss;
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
__global__ void __launch_bounds__(kThreadsSsm) ssm_chunked_kernel(const SsmArgs a) {
  __shared__ float u[kChunk][kPB];
  __shared__ float bs[kChunk][kNMax + 1];
  __shared__ float cs[kChunk][kNMax + 1];
  __shared__ float mm[kChunk][kChunk + 1];
  __shared__ float st[kPB][kNMax + 1];
  __shared__ float lraw[kChunk];
  __shared__ float la[kChunk];
  __shared__ float wlast[kChunk];   // exp(la_last - la_s)

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long bi = bh / a.h, hi = bh % a.h;
  const long long p0 = (long long)blockIdx.y * kPB;
  const int n = static_cast<int>(a.n);

  const T* xp = static_cast<const T*>(a.x) + bi * a.xsb + hi * a.xsh;
  const float* dtp = a.dt + bi * a.dsb + hi * a.dsh;
  const float* ap = a.decay + bi * a.asb + hi * a.ash;
  const T* bp = static_cast<const T*>(a.bm) + bi * a.bsb;
  const T* cp = static_cast<const T*>(a.cm) + bi * a.csb;
  T* yp = static_cast<T*>(a.y) + bi * a.ysb + hi * a.ysh;

  for (int e = tid; e < kPB * n; e += kThreadsSsm) st[e / n][e % n] = 0.f;

  for (long long c0 = 0; c0 < a.s; c0 += kChunk) {
    // stage the chunk: u = dt * x on this block's rows, B, C, log-decays
    for (int e = tid; e < kChunk * kPB; e += kThreadsSsm) {
      const int t = e / kPB, pp = e % kPB;
      const long long pos = c0 + t, pr = p0 + pp;
      float val = 0.f;
      if (pos < a.s && pr < a.p) val = dtp[pos * a.dss] * to_f(xp[pos * a.xss + pr]);
      u[t][pp] = val;
    }
    for (int e = tid; e < kChunk * n; e += kThreadsSsm) {
      const int t = e / n, k = e % n;
      const long long pos = c0 + t;
      const bool in = pos < a.s;
      bs[t][k] = in ? to_f(bp[pos * a.bss + k]) : 0.f;
      cs[t][k] = in ? to_f(cp[pos * a.css + k]) : 0.f;
    }
    if (tid < kChunk) {
      const long long pos = c0 + tid;
      lraw[tid] = pos < a.s ? logf(fmaxf(ap[pos * a.ass], 1e-30f)) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        run += lraw[t];
        la[t] = run;
      }
    }
    __syncthreads();
    const float la_last = la[kChunk - 1];
    if (tid < kChunk) wlast[tid] = expf(la_last - la[tid]);
    // mm[t][s] = exp(la_t - la_s) (C_t . B_s) for s <= t, else 0
    for (int e = tid; e < kChunk * kChunk; e += kThreadsSsm) {
      const int t = e / kChunk, s = e % kChunk;
      float val = 0.f;
      if (t >= s) {
        float cb = 0.f;
        for (int k = 0; k < n; ++k) cb = fmaf(cs[t][k], bs[s][k], cb);
        val = expf(la[t] - la[s]) * cb;
      }
      mm[t][s] = val;
    }
    __syncthreads();
    // y = exp(la_t) (C_t . S_prev) + sum_s mm[t][s] u_s
    for (int e = tid; e < kChunk * kPB; e += kThreadsSsm) {
      const int t = e / kPB, pp = e % kPB;
      const long long pos = c0 + t, pr = p0 + pp;
      if (pos >= a.s || pr >= a.p) continue;
      float ycs = 0.f;
      for (int k = 0; k < n; ++k) ycs = fmaf(cs[t][k], st[pp][k], ycs);
      float yi = 0.f;
      for (int s = 0; s <= t; ++s) yi = fmaf(mm[t][s], u[s][pp], yi);
      yp[pos * a.yss + pr] = from_f<T>(expf(la[t]) * ycs + yi);
    }
    __syncthreads();
    // S_new = exp(la_last) S_prev + sum_s exp(la_last - la_s) u_s (x) B_s
    const float dlast = expf(la_last);
    for (int e = tid; e < kPB * n; e += kThreadsSsm) {
      const int pp = e / n, k = e % n;
      float acc = 0.f;
      for (int s = 0; s < kChunk; ++s) acc = fmaf(u[s][pp] * wlast[s], bs[s][k], acc);
      st[pp][k] = dlast * st[pp][k] + acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < kPB * n; e += kThreadsSsm) {
    const int pp = e / n, k = e % n;
    const long long pr = p0 + pp;
    if (pr < a.p) a.state[((bh * a.p) + pr) * a.n + k] = st[pp][k];
  }
}

}  // namespace

// meta: b, h, s, p, n, then the strides in elements: x (batch, head, pos),
// dt (batch, head, pos), decay (batch, head, pos), B (batch, pos),
// C (batch, pos), y (batch, head, pos). dtype of x, B, C and y: 0 float32,
// 1 bfloat16. state: (b, h, p, n) float32, contiguous. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for n outside [1, 32] or an
// unknown dtype.
extern "C" int repro_ssm_scan_chunked(const void* x, const void* dt, const void* decay,
                                      const void* bm, const void* cm, void* y,
                                      void* state, const long long* meta, int dtype,
                                      int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  SsmArgs a;
  a.x = x; a.dt = static_cast<const float*>(dt); a.decay = static_cast<const float*>(decay);
  a.bm = bm; a.cm = cm; a.y = y; a.state = static_cast<float*>(state);
  a.b = meta[0]; a.h = meta[1]; a.s = meta[2]; a.p = meta[3]; a.n = meta[4];
  a.xsb = meta[5]; a.xsh = meta[6]; a.xss = meta[7];
  a.dsb = meta[8]; a.dsh = meta[9]; a.dss = meta[10];
  a.asb = meta[11]; a.ash = meta[12]; a.ass = meta[13];
  a.bsb = meta[14]; a.bss = meta[15];
  a.csb = meta[16]; a.css = meta[17];
  a.ysb = meta[18]; a.ysh = meta[19]; a.yss = meta[20];
  if (a.n < 1 || a.n > kNMax) return static_cast<int>(cudaErrorInvalidValue);
  if (a.b <= 0 || a.h <= 0 || a.p <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(a.b * a.h), static_cast<unsigned>((a.p + kPB - 1) / kPB));
  if (dtype == 0) ssm_chunked_kernel<float><<<grid, kThreadsSsm, 0, st>>>(a);
  else if (dtype == 1) ssm_chunked_kernel<__nv_bfloat16><<<grid, kThreadsSsm, 0, st>>>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
