// ssm_scan_chunked: the Mamba-style selective scan of the LLM prefill in SSD
// block form, from a zero state, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan.py:82
// (ssm_scan_chunked, pallas_call at ssm_scan.py:116), whose body
// (ssm_scan.py:33-79) it computes chunk by chunk (64 steps), with u = dt * x
// and la = cumsum(log(max(a, 1e-30))) over the chunk:
//   y_t   = exp(la_t) (C_t . S_in) + sum_{s<=t} exp(la_t - la_s) (C_t . B_s) u_s
//   S_out = exp(la_last) S_in + dS,   dS = sum_s exp(la_last - la_s) u_s (x) B_s
// Every exponent is a later-minus-earlier difference of log-cumsums, so it is
// <= 0; nothing is factored as exp(la) exp(-la). The main path reaches it
// through repro_torch.models.ssm.ssm_scan with no carried state (every
// prefill layer of a hybrid model).
//
// Bound: bytes. x and y dominate (B*H*S*P elements each; 215 MB in float32
// at hymba's prefill shape, 0.0645 ms at 3.35 TB/s). The three phases move
// about 0.42 GB there (x is read twice, the scratch written twice and read
// twice) and do about 3.9 GFLOP from shared memory; without tensor cores (the
// main path is float32) the instruction stream, not the bytes, sets their
// pace.
//
// Design: a chunk-parallel scan in three launches, since only the (P, N)
// state has to pass from chunk to chunk.
//   1. ssm_chunked_state_kernel, one block per (batch * head, chunk): the
//      chunk's log-decay cumsum (a warp-shuffle scan), its la_last, and its
//      own state contribution dS, a (P, 64) x (64, N) product from shared
//      memory in 4 x 1 register tiles.
//   2. ssm_chunked_pass_kernel, one thread per (batch * head, p, n) state
//      element: S <- exp(la_last) S + dS over the chunks, eight chunks' dS
//      and la_last loaded ahead of their FMAs. It overwrites each dS with
//      S_in, the state entering that chunk, and writes the final state. This
//      is the only serial part: 1024 independent affine recurrences of
//      S / 64 steps at hymba's shape.
//   3. ssm_chunked_out_kernel, one block per (batch * head, chunk): all of the
//      chunk's loads (x, S_in, C, B) issued at once; the masked decay-weighted
//      C.B matrix M once for all P columns (4 x 4 register tiles, those above
//      the diagonal skipped), and beside it the state term C_t . S_in; then
//      y = exp(la_t) (C_t . S_in) + M u in 4 x 4 register tiles, each value
//      loaded from shared memory used four times.
// What this does about the one-launch design it replaces (one block per
// (batch * head, 32 state rows) walking all chunks in order, 18x its bound):
// (1) 6,400 blocks instead of 400 at hymba's shape, the chunk walk cut down to
// the state pass; (2) the cumsum is a warp scan, not one thread's loop; (3) M
// is formed once per (batch * head, chunk), not once per 32 state rows; (4)
// both products are register-tiled.
//
// The cumsum is summed in float64: where runs of decays at the 1e-30 clamp
// make |la| reach hundreds, a float32 cumsum loses ~|la| 2^-24 per step in
// every difference la_t - la_s.
//
// Scratch (float32, from the caller): dS, then S_in, as (B, H, nc, P, N),
// then la_last as (B, H, nc); 26.2 MB at hymba's prefill shape (B = 8,
// H = 25, S = 2048, P = 64, N = 16).
//
// A chunk that runs past S is masked: its tail steps get u = 0, B = C = 0 and
// log-decay 0, which is exactly the reference's padding with dt = 0 and
// decay = 1, so any S is taken.
//
// Layout: any strides for (batch, head, position) of x, y, dt and decay and
// for (batch, position) of B and C; the last dim of x, y, B and C must be
// contiguous. The model passes its (B, S, H, P) activations as (B, H, S, P)
// views. x, B and C are float32 or bfloat16 (one type), dt and decay float32;
// y has x's type, the final state (B, H, P, N) is float32.

#include "common.cuh"

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>

namespace {

constexpr int kChunk = 64;
constexpr int kPS = 64;            // state rows (P) per slice of a block's loop
constexpr int kNMax = 32;          // largest state dim N
constexpr int kThreadsSsm = 256;
constexpr int kLd = kChunk + 4;    // row stride of the (k, t) and (k, p) tiles:
                                   // float4-aligned, at most 2-way store conflicts
constexpr int kPassAhead = 8;      // chunks loaded ahead in the state pass

struct SsmArgs {
  const void* x;
  const float* dt;
  const float* decay;
  const void* bm;
  const void* cm;
  void* y;
  float* state;
  float* dstate;    // (B*H, nc, P, N): dS from phase 1, S_in after phase 2
  float* lalast;    // (B*H, nc)
  long long b, h, s, p, n, nc;
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Tiles are staged in two steps: load() brings all of a thread's elements
// into registers, store() puts them in shared memory, so that no global load
// waits behind a shared-memory store (the compiler may not reorder the two
// across a generic pointer). Each thread keeps one column and walks rows, so
// that its addresses advance by one stride.

// The (64, kPS) slice of x from column p0 of the chunk at c0, 0 past S or past
// the slice's width pw; stored as u[t][pp] = scale[t] x[t][pp]. kVec: 4-element
// vectors (pw is then a multiple of 4, so a vector is all in or all out).
template <typename T, bool kVec>
struct XSlice {
  static constexpr int kW = kVec ? 4 : 1;                // elements per load
  static constexpr int kCols = kPS / kW;                 // threads per row
  static constexpr int kRows = kThreadsSsm / kCols;      // rows per pass
  static constexpr int kR = kChunk / kRows;              // passes
  float v[kR][kW];

  __device__ __forceinline__ void load(const T* xp, long long xss, long long c0, long long s,
                                       long long p0, int pw) {
    const int col = kW * (threadIdx.x % kCols), t0 = threadIdx.x / kCols;
    const T* src = xp + (c0 + t0) * xss + p0 + col;
    const long long step = kRows * xss;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool in = c0 + t0 + r * kRows < s && col < pw;
      if constexpr (kVec) {
        const float4 q = in ? load4(src + r * step) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[r][0] = q.x; v[r][1] = q.y; v[r][2] = q.z; v[r][3] = q.w;
      } else {
        v[r][0] = in ? to_f(src[r * step]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* u, const float* scale) const {
    const int col = kW * (threadIdx.x % kCols), t0 = threadIdx.x / kCols;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int t = t0 + r * kRows;
      const float c = scale[t];
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(&u[t * kPS + col]) =
            make_float4(c * v[r][0], c * v[r][1], c * v[r][2], c * v[r][3]);
      } else {
        u[t * kPS + col] = c * v[r][0];
      }
    }
  }
};

// rows[r][k] = src[r * ld + k] (T converted to float) for r < 64 and k < n,
// 0 for r >= valid: thread tid takes k = tid % 32 and every 8th row from
// tid / 32. store(put) calls put(row, k, value) for each one.
struct RowsN {
  static constexpr int kStep = kThreadsSsm / kNMax;
  static constexpr int kR = kChunk / kStep;
  float v[kR];

  template <typename T>
  __device__ __forceinline__ void load(const T* src, long long ld, int n, long long valid) {
    const int k = threadIdx.x % kNMax, r0 = threadIdx.x / kNMax;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = r0 + i * kStep;
      v[i] = k < n && r < valid ? to_f(src[r * ld + k]) : 0.f;
    }
  }

  template <typename Put>
  __device__ __forceinline__ void store(int n, Put put) const {
    const int k = threadIdx.x % kNMax, r0 = threadIdx.x / kNMax;
    if (k >= n) return;
#pragma unroll
    for (int i = 0; i < kR; ++i) put(r0 + i * kStep, k, v[i]);
  }
};

// la[t] = the chunk's inclusive cumsum of log(max(decay, 1e-30)), summed in
// float64 on warp 0 (lane l takes steps 2l and 2l+1, then a shuffle scan over
// the lanes). Steps past S get log-decay 0. The sums are float64 so that a
// difference la_t - la_s keeps float32 precision where runs of strong decay
// make |la| large. Phases 1 and 3 run this same code on the same inputs, so
// they see the same la bit for bit. The caller synchronises before reading la.
__device__ __forceinline__ void chunk_log_cumsum(const float* ap, long long ass, long long c0,
                                                 long long s, double* la) {
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x;
  const long long pos = c0 + 2 * l;
  const double a0 = pos < s ? logf(fmaxf(ap[pos * ass], 1e-30f)) : 0.f;
  const double a1 = pos + 1 < s ? logf(fmaxf(ap[(pos + 1) * ass], 1e-30f)) : 0.f;
  double incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (l >= o) incl += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (l == 0) excl = 0.0;
  la[2 * l] = excl + a0;
  la[2 * l + 1] = (excl + a0) + a1;
}

// exp(later - earlier), an exponent <= 0 for decays <= 1
__device__ __forceinline__ float exp_diff(double later, double earlier) {
  return expf(static_cast<float>(later - earlier));
}

// Phase 1: la_last and dS[p][n] = sum_s (dt_s exp(la_last - la_s) x_s[p]) B_s[n].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreadsSsm, 6) ssm_chunked_state_kernel(const SsmArgs a) {
  __shared__ __align__(16) float uw[kChunk * kPS];
  __shared__ float bs[kChunk][kNMax];
  __shared__ double la[kChunk];
  __shared__ float w[kChunk];     // dt_s exp(la_last - la_s)

  const int tid = threadIdx.x;
  const long long cb = blockIdx.x;    // (batch * head, chunk), as in the scratch
  const long long bh = cb / a.nc, c0 = cb % a.nc * kChunk;
  const long long bi = bh / a.h, hi = bh % a.h;
  const int n = static_cast<int>(a.n);

  const T* xp = static_cast<const T*>(a.x) + bi * a.xsb + hi * a.xsh;
  const float* dtp = a.dt + bi * a.dsb + hi * a.dsh;
  const T* bp = static_cast<const T*>(a.bm) + bi * a.bsb;

  {
    RowsN br;
    br.load(bp + c0 * a.bss, a.bss, n, a.s - c0);
    chunk_log_cumsum(a.decay + bi * a.asb + hi * a.ash, a.ass, c0, a.s, la);
    br.store(n, [&](int t, int k, float v) { bs[t][k] = v; });
  }
  __syncthreads();
  const double la_last = la[kChunk - 1];
  if (tid < kChunk) {
    const long long pos = c0 + tid;
    w[tid] = pos < a.s ? dtp[pos * a.dss] * exp_diff(la_last, la[tid]) : 0.f;
  }
  if (tid == 0) a.lalast[cb] = static_cast<float>(la_last);

  float* ds = a.dstate + cb * a.p * n;
  for (long long p0 = 0; p0 < a.p; p0 += kPS) {
    const int pw = static_cast<int>(min(static_cast<long long>(kPS), a.p - p0));
    XSlice<T, kVec> xs;
    xs.load(xp, a.xss, c0, a.s, p0, pw);
    __syncthreads();    // w is ready; the last slice's uw is consumed
    xs.store(uw, w);
    __syncthreads();
    // a 4 (p) x 1 (n) tile per thread
    for (int e = tid; e < (kPS / 4) * n; e += kThreadsSsm) {
      const int pg = e / n, k = e % n;
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll 8
      for (int s = 0; s < kChunk; ++s) {
        const float4 u4 = *reinterpret_cast<const float4*>(&uw[s * kPS + 4 * pg]);
        const float bv = bs[s][k];
        acc0 = fmaf(u4.x, bv, acc0);
        acc1 = fmaf(u4.y, bv, acc1);
        acc2 = fmaf(u4.z, bv, acc2);
        acc3 = fmaf(u4.w, bv, acc3);
      }
      const int pl = 4 * pg;
      float* dp = ds + (p0 + pl) * n + k;
      if (pl < pw) dp[0] = acc0;
      if (pl + 1 < pw) dp[n] = acc1;
      if (pl + 2 < pw) dp[2 * n] = acc2;
      if (pl + 3 < pw) dp[3 * n] = acc3;
    }
  }
}

// Phase 2: the state pass. Thread e of (batch * head) bh walks its element
// S[e] over the chunks; each dS is replaced by the S_in of its chunk.
__global__ void __launch_bounds__(kThreadsSsm) ssm_chunked_pass_kernel(
    float* dstate, const float* lalast, float* state, long long pn, long long nc,
    long long blocks_per_bh) {
  const long long bh = blockIdx.x / blocks_per_bh;
  const long long e = (blockIdx.x % blocks_per_bh) * kThreadsSsm + threadIdx.x;
  if (e >= pn) return;
  float* d = dstate + bh * nc * pn + e;
  const float* g = lalast + bh * nc;
  float st = 0.f;
  for (long long c0 = 0; c0 < nc; c0 += kPassAhead) {
    float dv[kPassAhead], gv[kPassAhead];
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j < nc) {
        dv[j] = d[(c0 + j) * pn];
        gv[j] = g[c0 + j];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j < nc) {
        d[(c0 + j) * pn] = st;
        st = fmaf(expf(gv[j]), st, dv[j]);
      }
    }
  }
  state[bh * pn + e] = st;
}

// Phase 3's dynamic shared memory: la (64 doubles), then in floats mt (s, t)
// and u (t, p) of 64 x 64, ct (k, t), bt (k, s) and st (k, p) of n x kLd,
// then ela and dts.
inline int out_smem_bytes(int n) {
  return static_cast<int>(sizeof(double) * kChunk +
                          sizeof(float) * (2 * kChunk * kChunk + 3 * n * kLd + 2 * kChunk));
}

// Phase 3: y of one chunk from its S_in.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreadsSsm, 4) ssm_chunked_out_kernel(const SsmArgs a) {
  extern __shared__ __align__(16) double smem_d[];
  const int n = static_cast<int>(a.n);
  double* la = smem_d;
  float* mt = reinterpret_cast<float*>(la + kChunk);   // M transposed: mt[s][t]
  float* u = mt + kChunk * kChunk;         // u[t][p] = dt_t x_t[p]
  float* ct = u + kChunk * kPS;            // ct[k][t] = C_t[k]
  float* bt = ct + n * kLd;                // bt[k][s] = B_s[k]
  float* st = bt + n * kLd;                // st[k][p] = S_in[p][k]
  float* ela = st + n * kLd;               // exp(la_t)
  float* dts = ela + kChunk;

  const int tid = threadIdx.x;
  const long long cb = blockIdx.x;    // (batch * head, chunk), as in the scratch
  const long long bh = cb / a.nc, c0 = cb % a.nc * kChunk;
  const long long bi = bh / a.h, hi = bh % a.h;

  const T* xp = static_cast<const T*>(a.x) + bi * a.xsb + hi * a.xsh;
  const float* dtp = a.dt + bi * a.dsb + hi * a.dsh;
  const T* bp = static_cast<const T*>(a.bm) + bi * a.bsb;
  const T* cp = static_cast<const T*>(a.cm) + bi * a.csb;
  T* yp = static_cast<T*>(a.y) + bi * a.ysb + hi * a.ysh;
  const float* s_in = a.dstate + cb * a.p * n;

  // every load of the first slice is issued before the first shared store
  const int pw0 = static_cast<int>(min(static_cast<long long>(kPS), a.p));
  {
    XSlice<T, kVec> xs;
    RowsN sr, cr, br;
    xs.load(xp, a.xss, c0, a.s, 0, pw0);
    sr.load(s_in, n, n, pw0);
    cr.load(cp + c0 * a.css, a.css, n, a.s - c0);
    br.load(bp + c0 * a.bss, a.bss, n, a.s - c0);
    chunk_log_cumsum(a.decay + bi * a.asb + hi * a.ash, a.ass, c0, a.s, la);
    if (tid >= 64 && tid < 64 + kChunk) {
      const long long pos = c0 + tid - 64;
      dts[tid - 64] = pos < a.s ? dtp[pos * a.dss] : 0.f;
    }
    cr.store(n, [&](int t, int k, float v) { ct[k * kLd + t] = v; });
    br.store(n, [&](int t, int k, float v) { bt[k * kLd + t] = v; });
    sr.store(n, [&](int pp, int k, float v) { st[k * kLd + pp] = v; });
    __syncthreads();    // dts is ready
    xs.store(u, dts);
  }
  if (tid < kChunk) ela[tid] = expf(static_cast<float>(la[tid]));

  // M[t][s] = exp(la_t - la_s) (C_t . B_s) for s <= t, else 0: a 4 (t) x 4 (s)
  // tile per thread, stored transposed; the tiles above the diagonal are never
  // read.
  {
    const int t0 = 4 * (tid % 16), s0 = 4 * (tid / 16);
    if (s0 <= t0) {
      float m[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 c4 = *reinterpret_cast<const float4*>(&ct[k * kLd + t0]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bt[k * kLd + s0]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[i][j] = fmaf(cv[i], bv[j], m[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          m[i][j] = s0 + j <= t0 + i ? exp_diff(la[t0 + i], la[s0 + j]) * m[i][j] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&mt[(s0 + j) * kChunk + t0]) =
            make_float4(m[0][j], m[1][j], m[2][j], m[3][j]);
    }
  }

  // y: a 4 (t) x 4 (p) tile per thread
  const int t0 = 4 * (tid / 16), pl = 4 * (tid % 16);
  for (long long p0 = 0; p0 < a.p; p0 += kPS) {
    const int pw = static_cast<int>(min(static_cast<long long>(kPS), a.p - p0));
    if (p0 > 0) {    // the first slice was staged with C and B
      XSlice<T, kVec> xs;
      RowsN sr;
      xs.load(xp, a.xss, c0, a.s, p0, pw);
      sr.load(s_in + p0 * n, n, n, pw);
      __syncthreads();    // the last slice is consumed
      xs.store(u, dts);
      sr.store(n, [&](int pp, int k, float v) { st[k * kLd + pp] = v; });
      __syncthreads();
    }
    // the state term needs only ct and st: it runs before the barrier that
    // publishes M, ela and u
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 c4 = *reinterpret_cast<const float4*>(&ct[k * kLd + t0]);
      const float4 s4 = *reinterpret_cast<const float4*>(&st[k * kLd + pl]);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = ela[t0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= d;
    }
    // M is zero above the diagonal, so s stops at the tile's last row; four
    // steps at a time (t0 + 4 is a multiple of 4)
    for (int s4 = 0; s4 < t0 + 4; s4 += 4) {
#pragma unroll
      for (int s = s4; s < s4 + 4; ++s) {
        const float4 m4 = *reinterpret_cast<const float4*>(&mt[s * kChunk + t0]);
        const float4 u4 = *reinterpret_cast<const float4*>(&u[s * kPS + pl]);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w}, uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], uv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long pos = c0 + t0 + i;
      if (pos >= a.s) break;
      T* row = yp + pos * a.yss + p0 + pl;
      if constexpr (kVec) {
        if (pl < pw) store4(row, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (pl + j < pw) row[j] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, bool kVec>
int launch(const SsmArgs& a, cudaStream_t stream) {
  const long long blocks = a.b * a.h * a.nc;
  const long long pn = a.p * a.n;
  const long long per_bh = (pn + kThreadsSsm - 1) / kThreadsSsm;
  if (blocks > INT_MAX || a.b * a.h * per_bh > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (blocks > 0) {
    ssm_chunked_state_kernel<T, kVec>
        <<<static_cast<unsigned>(blocks), kThreadsSsm, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  ssm_chunked_pass_kernel<<<static_cast<unsigned>(a.b * a.h * per_bh), kThreadsSsm, 0, stream>>>(
      a.dstate, a.lalast, a.state, pn, a.nc, per_bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    const int smem = out_smem_bytes(static_cast<int>(a.n));
    err = cudaFuncSetAttribute(ssm_chunked_out_kernel<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssm_chunked_out_kernel<T, kVec>
        <<<static_cast<unsigned>(blocks), kThreadsSsm, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const SsmArgs& a, bool vec, cudaStream_t stream) {
  return vec ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

// Rows of 4-element vectors: the base is aligned to 4 elements and every
// stride and the row length P are multiples of 4.
bool vec_rows(const void* base, int esize, long long p, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(base) % (4 * esize) == 0 && p % 4 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && ss % 4 == 0;
}

}  // namespace

// meta: b, h, s, p, n, then the strides in elements: x (batch, head, pos),
// dt (batch, head, pos), decay (batch, head, pos), B (batch, pos),
// C (batch, pos), y (batch, head, pos). dtype of x, B, C and y: 0 float32,
// 1 bfloat16. state: (b, h, p, n) float32, contiguous. scratch: float32, at
// least b*h*nc*(p*n + 1) elements with nc = ceil(s / 64). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for n outside [1, 32], an
// unknown dtype or a grid too large.
extern "C" int repro_ssm_scan_chunked(const void* x, const void* dt, const void* decay,
                                      const void* bm, const void* cm, void* y,
                                      void* state, void* scratch, const long long* meta,
                                      int dtype, int device, void* stream) {
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
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.b <= 0 || a.h <= 0 || a.p <= 0) return static_cast<int>(cudaGetLastError());
  a.nc = (a.s + kChunk - 1) / kChunk;
  a.dstate = static_cast<float*>(scratch);
  a.lalast = a.dstate + a.b * a.h * a.nc * a.p * a.n;
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = vec_rows(x, esize, a.p, a.xsb, a.xsh, a.xss) &&
                   vec_rows(y, esize, a.p, a.ysb, a.ysh, a.yss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, vec, st) : launch<__nv_bfloat16>(a, vec, st);
}
