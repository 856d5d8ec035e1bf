// rwkv6_chunked: the wkv6 recurrence of the RWKV6 ("Finch") prefill in block
// form, from a zero state, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6.py:89 (rwkv6_chunked,
// pallas_call at rwkv6.py:124), whose body (rwkv6.py:39-86) it computes in
// the same inner chunks of 32 steps. With lw = cumsum(log(max(w, 1e-30)))
// over the inner chunk and lx = lw - log(max(w, 1e-30)):
//   y_t    = (r_t * exp(lx_t)) . S_prev + sum_s A[t][s] v_s
//   A[t,s] = sum_k r_tk k_sk exp(lx_tk - lw_sk)   (s < t)
//   A[t,t] = sum_k r_tk u_k k_tk
//   S_new  = diag(exp(lw_last)) S_prev + sum_s (k_s * exp(lw_last - lw_s))^T v_s
// Every exponent is a later-minus-earlier difference of log-cumsums taken
// within one inner chunk, so it is <= 0 under any decay; nothing is factored
// as exp(lw) exp(-lw), and no cumsum runs across inner chunks (at the 1e-30
// clamp |lw| grows by 69 a step). The cumsum is summed in order, step by
// step, as a sequential cumsum sums it. The main path reaches
// it through repro_torch.models.rwkv.time_mix with no carried state (every
// prefill layer of an rwkv model).
//
// Design: a chunk-parallel scan in three launches, since only the (K, V)
// state passes from chunk to chunk. A state chunk is kL = 128 steps, four
// inner chunks; nc = ceil(S / kL).
//   1. rwkv6_chunked_state_kernel, one block per (batch * head, state
//      chunk), 8,192 at the prefill shape: from a zero state, the
//      reference's update over the state chunk's inner chunks,
//      S <- diag(exp(lw_last)) S + (k * exp(lw_last - lw))^T v, the state
//      kept in 4 x 4 register tiles; it writes the state chunk's own
//      contribution dS and its decay g = prod exp(lw_last) per key channel.
//   2. rwkv6_chunked_pass_kernel, one thread per (batch * head, k, 4 v)
//      state elements: S <- g[k] S + dS over the state chunks, eight chunks
//      loaded ahead of their FMAs. It overwrites each dS with S_in, the state
//      entering that chunk, and writes the final state.
//   3. rwkv6_chunked_out_kernel, one block per (batch * head, state chunk),
//      all V <= 64 value columns in one block, so A is formed once per inner
//      chunk: S_in into shared memory, then per inner chunk the staged r, k,
//      v and log w, the cumsum, A's strict lower triangle (a 1 x 2 tile per
//      thread: 256 tiles hold its 496 entries) and its diagonal, r and k
//      scaled by their decays in place, then at once y = (r * exp(lx)) . S +
//      A v on warps 0-3 (4 x 4 register tiles) and the in-block state update
//      on warps 4-7 (8 x 4 tiles; skipped after the last inner chunk). Every
//      shared load of the products is 16 bytes and feeds 8 to 32 FMAs.
// Both block kernels ask L2 for the next inner chunk while they work on this
// one. The cumsum stays one lane per key channel, summed in order as a
// sequential cumsum sums it (a reordered sum would add rounding at |lw| in
// the thousands), and taking it out of the output kernel saved no
// measurable time (tools/rwkv6_variants.py, NVIDIA H100 80GB HBM3
// at 700 W).
// What this does about the one-launch design it replaces (one block per
// (batch * head, 32 value columns) walking all chunks in order, one output
// entry per thread, 15.5x its bound on the same card): 8x the blocks, the
// chunk walk cut down to the state pass, A formed once per head instead of
// twice, and register tiles in place of two shared loads per FMA. A's exps (1.1 G at the prefill
// shape, one per term) now set the output kernel's pace.
//
// Scratch (float32, from the caller): dS, then S_in, as (B, H, nc, K, V),
// then g as (B, H, nc, K); B*H*nc*(K*V + K) elements, 136.3 MB at rwkv6-7b's
// prefill shape (B = 8, H = 64, S = 2048, K = V = 64).
//
// A state chunk or inner chunk that runs past S is masked: its tail steps
// get r = k = v = 0 and log-decay 0, which leaves y and the state exactly
// unchanged, so any S is taken. Channels past K or V are zero in shared
// memory, so every tile runs over 64.
//
// Bound: bytes. r, k, v, w and y are B*H*S*64 elements each: 1.35 GB or
// 0.40 ms at 3.35 TB/s in float32 at the prefill shape. This design reads k,
// v and w twice and moves the scratch four times (0.55 GB), a floor of
// 0.80 ms; its ~1.1 G exps and ~12 G FMAs from shared memory on the CUDA
// cores (the fp32 tolerance rules out TF32) keep it above that.
//
// Layout: any strides for (batch, head, position) of r, k, v, w and y; the
// last dim of each must be contiguous. The model passes its (B, S, H, K)
// activations as (B, H, S, K) views. r, k and v are float32 or bfloat16 (one
// type), w and u float32; y has v's type, the final state (B, H, K, V) is
// float32. K and V are at most 64. Rows move as 4-element vectors when K, V,
// every stride and base allow it, else element by element.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kChunk = 32;                    // the reference's inner chunk
constexpr int kL = 128;                       // state chunk: steps per block
constexpr int kKMax = 64;
constexpr int kVMax = 64;
constexpr int kLd = kKMax + 4;                // row stride of the (t, k) tiles:
                                              // 16-byte rows, 4 banks apart
constexpr int kLdA = kChunk + 4;
constexpr int kThreadsWkv = 256;
constexpr int kPassAhead = 8;                 // state chunks loaded ahead in the pass

static_assert(kL % kChunk == 0, "a state chunk is a whole number of inner chunks");
static_assert(kChunk * kKMax / 4 == 2 * kThreadsWkv, "staging: two vectors a thread");

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* y;
  float* state;
  float* dstate;    // (B*H, nc, K, V): dS from the state kernel, S_in after the pass
  float* gdec;      // (B*H, nc, K): the state chunk's decay per key channel
  long long b, h, s, kd, vd, nc;
  long long rsb, rsh, rss, ksb, ksh, kss, vsb, vsh, vss, wsb, wsh, wss, ysb, ysh, yss;
};

// Four consecutive elements as loaded, converted to float only when stored,
// so that all of a thread's loads are in flight before the first is used.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
};
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;    // four bfloat16, element 0 in the low half of v.x
};

__device__ __forceinline__ float4 to_f4(const Raw4<float>& x) { return x.v; }
__device__ __forceinline__ float4 to_f4(const Raw4<__nv_bfloat16>& x) {
  return make_float4(__uint_as_float(x.v.x << 16), __uint_as_float(x.v.x & 0xffff0000u),
                     __uint_as_float(x.v.y << 16), __uint_as_float(x.v.y & 0xffff0000u));
}

// row[col .. col + 3], `fill` where !in or at or past n. kVec: one aligned
// vector load (n is then a multiple of 4).
template <bool kVec>
__device__ __forceinline__ Raw4<float> load4(const float* row, int col, int n, bool in,
                                             float fill = 0.f) {
  Raw4<float> o;
  if constexpr (kVec) {
    o.v = in && col < n ? *reinterpret_cast<const float4*>(row + col)
                        : make_float4(fill, fill, fill, fill);
  } else {
    o.v.x = in && col < n ? row[col] : fill;
    o.v.y = in && col + 1 < n ? row[col + 1] : fill;
    o.v.z = in && col + 2 < n ? row[col + 2] : fill;
    o.v.w = in && col + 3 < n ? row[col + 3] : fill;
  }
  return o;
}

template <bool kVec>
__device__ __forceinline__ Raw4<__nv_bfloat16> load4(const __nv_bfloat16* row, int col, int n,
                                                     bool in) {
  Raw4<__nv_bfloat16> o;
  if constexpr (kVec) {
    o.v = in && col < n ? *reinterpret_cast<const uint2*>(row + col) : make_uint2(0u, 0u);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = in && col + i < n ? p[col + i] : 0u;
    o.v = make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
  }
  return o;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int col, int n, float4 x) {
  if constexpr (kVec) {
    if (col < n) *reinterpret_cast<float4*>(row + col) = x;
  } else {
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < n) row[col + i] = e[i];
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* row, int col, int n, float4 x) {
  if constexpr (kVec) {
    if (col < n) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 q;
      q.x = *reinterpret_cast<const unsigned*>(&lo);
      q.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(row + col) = q;
    }
  } else {
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < n) row[col + i] = __float2bfloat16(e[i]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// One inner chunk's k, v and w (and r, kWithR) for steps c0 .. c0 + 31: thread
// tid takes the vectors tid and tid + 256 of each (32, 64) tile, row e / 16 and
// columns 4 (e % 16) .. + 3, so a warp reads two whole rows. load() starts the
// global loads; store() puts them in shared memory, w as log(max(w, 1e-30))
// (log-decay 0 past S or past K).
template <typename T, bool kVec, bool kWithR>
struct ChunkLoad {
  Raw4<T> r[2], k[2], v[2];
  Raw4<float> w[2];

  __device__ __forceinline__ void load(const T* rp, const T* kp, const T* vp, const float* wp,
                                       const WkvArgs& a, long long c0) {
    const int kd = static_cast<int>(a.kd), vd = static_cast<int>(a.vd);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreadsWkv, t = e >> 4, col = 4 * (e & 15);
      const long long pos = c0 + t;
      const bool in = pos < a.s;
      if constexpr (kWithR) r[i] = load4<kVec>(rp + pos * a.rss, col, kd, in);
      k[i] = load4<kVec>(kp + pos * a.kss, col, kd, in);
      v[i] = load4<kVec>(vp + pos * a.vss, col, vd, in);
      w[i] = load4<kVec>(wp + pos * a.wss, col, kd, in, 1.f);
    }
  }

  __device__ __forceinline__ void store(float (*rs)[kLd], float (*ks)[kLd], float (*vs)[kVMax],
                                        float (*ls)[kLd]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + i * kThreadsWkv, t = e >> 4, col = 4 * (e & 15);
      if constexpr (kWithR) st4(&rs[t][col], to_f4(r[i]));
      st4(&ks[t][col], to_f4(k[i]));
      st4(&vs[t][col], to_f4(v[i]));
      const float4 x = w[i].v;
      st4(&ls[t][col], make_float4(logf(fmaxf(x.x, 1e-30f)), logf(fmaxf(x.y, 1e-30f)),
                                   logf(fmaxf(x.z, 1e-30f)), logf(fmaxf(x.w, 1e-30f))));
    }
  }
};

// Asks L2 for the inner chunk at c0 (r, k, v and w rows, 128 bytes a thread),
// so that its loads at the top of the next inner chunk do not wait on device
// memory.
template <typename T>
__device__ __forceinline__ void prefetch_chunk(const T* rp, const T* kp, const T* vp,
                                               const float* wp, const WkvArgs& a, long long c0) {
  const int t = threadIdx.x >> 3, which = (threadIdx.x >> 1) & 3, part = threadIdx.x & 1;
  const long long pos = c0 + t;
  const void* row = which == 0   ? static_cast<const void*>(rp + pos * a.rss)
                    : which == 1 ? static_cast<const void*>(kp + pos * a.kss)
                    : which == 2 ? static_cast<const void*>(vp + pos * a.vss)
                                 : static_cast<const void*>(wp + pos * a.wss);
  const long long bytes = which == 3 ? a.kd * 4 : (which == 2 ? a.vd : a.kd) * sizeof(T);
  if (pos < a.s && part * 128 < bytes)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(static_cast<const char*>(row) + part * 128));
}

struct StateSmem {
  float k[kChunk][kLd];       // k, then k * exp(lw_last - lw)
  float l[kChunk][kLd];       // log w, then its inclusive cumsum
  float v[kChunk][kVMax];
  float e[kKMax];             // exp(lw_last)
};

// Phase 1: dS, the state chunk's own contribution from a zero state, and g,
// its decay per key channel.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreadsWkv, 3) rwkv6_chunked_state_kernel(const WkvArgs a) {
  __shared__ __align__(16) StateSmem sm;
  const int tid = threadIdx.x;
  const long long cb = blockIdx.x;    // (batch * head, state chunk), as in the scratch
  const long long bh = cb / a.nc, cs = cb % a.nc * kL;
  const long long bi = bh / a.h, hi = bh % a.h;

  const T* kp = static_cast<const T*>(a.k) + bi * a.ksb + hi * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.vsb + hi * a.vsh;
  const float* wp = a.w + bi * a.wsb + hi * a.wsh;

  const int kk0 = 4 * (tid >> 4), v0 = 4 * (tid & 15);    // this thread's 4 x 4 tile
  float st[4][4] = {};
  float g = 1.f;                                            // channel tid < 64

  for (long long c0 = cs; c0 < cs + kL && c0 < a.s; c0 += kChunk) {
    {
      ChunkLoad<T, kVec, false> ld;
      ld.load(nullptr, kp, vp, wp, a, c0);
      ld.store(nullptr, sm.k, sm.v, sm.l);
    }
    // no r here: k takes its place
    if (c0 + kChunk < cs + kL && c0 + kChunk < a.s) prefetch_chunk(kp, kp, vp, wp, a, c0 + kChunk);
    __syncthreads();
    if (tid < kKMax) {
      // a lane per key channel: the cumsum in order
      float run = 0.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        run += sm.l[t][tid];
        sm.l[t][tid] = run;
      }
      const float e = expf(run);
      sm.e[tid] = e;
      g *= e;
    }
    __syncthreads();
    // k * exp(lw_last - lw), in place
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreadsWkv, t = e >> 4, c = 4 * (e & 15);
      const float4 k4 = ld4(&sm.k[t][c]), l4 = ld4(&sm.l[t][c]), z4 = ld4(&sm.l[kChunk - 1][c]);
      st4(&sm.k[t][c], make_float4(k4.x * expf(z4.x - l4.x), k4.y * expf(z4.y - l4.y),
                                   k4.z * expf(z4.z - l4.z), k4.w * expf(z4.w - l4.w)));
    }
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 8
    for (int s = 0; s < kChunk; ++s) {
      const float4 k4 = ld4(&sm.k[s][kk0]), v4 = ld4(&sm.v[s][v0]);
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kv[i], vv[j], acc[i][j]);
    }
    const float4 e4 = ld4(&sm.e[kk0]);
    const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = fmaf(ev[i], st[i][j], acc[i][j]);
    __syncthreads();    // the tiles are consumed before the next chunk is stored
  }

  const int kd = static_cast<int>(a.kd), vd = static_cast<int>(a.vd);
  float* ds = a.dstate + cb * a.kd * a.vd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (kk0 + i < kd)
      store4<kVec>(ds + (kk0 + i) * vd, v0, vd, make_float4(st[i][0], st[i][1], st[i][2], st[i][3]));
  if (tid < kd) a.gdec[cb * a.kd + tid] = g;
}

// Phase 2: the state pass. A thread walks kW consecutive elements of one row
// k of S over the state chunks; each dS is replaced by the S_in of its chunk.
template <int kW>
__global__ void __launch_bounds__(kThreadsWkv) rwkv6_chunked_pass_kernel(
    float* dstate, const float* gdec, float* state, long long kd, long long vd, long long nc,
    long long blocks_per_bh) {
  const long long kv = kd * vd;
  const long long bh = blockIdx.x / blocks_per_bh;
  const long long e = ((blockIdx.x % blocks_per_bh) * kThreadsWkv + threadIdx.x) * kW;
  if (e >= kv) return;
  float* d = dstate + bh * nc * kv + e;
  const float* g = gdec + bh * nc * kd + e / vd;
  float st[kW] = {};
  for (long long c0 = 0; c0 < nc; c0 += kPassAhead) {
    float dv[kPassAhead][kW], gv[kPassAhead];
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j < nc) {
        if constexpr (kW == 4) {
          const float4 x = ld4(d + (c0 + j) * kv);
          dv[j][0] = x.x; dv[j][1] = x.y; dv[j][2] = x.z; dv[j][3] = x.w;
        } else {
          dv[j][0] = d[(c0 + j) * kv];
        }
        gv[j] = g[(c0 + j) * kd];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j < nc) {
        if constexpr (kW == 4) {
          st4(d + (c0 + j) * kv, make_float4(st[0], st[1], st[2], st[3]));
        } else {
          d[(c0 + j) * kv] = st[0];
        }
#pragma unroll
        for (int i = 0; i < kW; ++i) st[i] = fmaf(gv[j], st[i], dv[j][i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kW; ++i) state[bh * kv + e + i] = st[i];
}

struct OutSmem {
  float r[kChunk][kLd];       // r, then r * exp(lx)
  float k[kChunk][kLd];       // k, then k * exp(lw_last - lw)
  float lw[kChunk][kLd];      // inclusive log-cumsum
  float lx[kChunk][kLd];      // log w, then lw - log w
  float v[kChunk][kVMax];
  float a[kChunk][kLdA];      // A; zero above the diagonal
  float st[kKMax][kVMax];     // the state entering the inner chunk
  float u[kKMax];
  float e[kKMax];             // exp(lw_last)
};

// Phase 3: y of one state chunk from its S_in, inner chunk by inner chunk.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreadsWkv, 3) rwkv6_chunked_out_kernel(const WkvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const long long cb = blockIdx.x;
  const long long bh = cb / a.nc, cs = cb % a.nc * kL;
  const long long bi = bh / a.h, hi = bh % a.h;
  const int kd = static_cast<int>(a.kd), vd = static_cast<int>(a.vd);

  const T* rp = static_cast<const T*>(a.r) + bi * a.rsb + hi * a.rsh;
  const T* kp = static_cast<const T*>(a.k) + bi * a.ksb + hi * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.vsb + hi * a.vsh;
  const float* wp = a.w + bi * a.wsb + hi * a.wsh;
  T* yp = static_cast<T*>(a.y) + bi * a.ysb + hi * a.ysh;
  const float* s_in = a.dstate + cb * a.kd * a.vd;

  for (int e = tid; e < kKMax * (kVMax / 4); e += kThreadsWkv) {
    const int kk = e / (kVMax / 4), c = 4 * (e % (kVMax / 4));
    st4(&sm.st[kk][c], to_f4(load4<kVec>(s_in + kk * vd, c, vd, kk < kd)));
  }
  for (int e = tid; e < kChunk * kLdA; e += kThreadsWkv) (&sm.a[0][0])[e] = 0.f;
  if (tid < kKMax) sm.u[tid] = tid < kd ? a.u[hi * kd + tid] : 0.f;

  // A's strict lower triangle in 1 x 2 tiles: row pt, columns ps and ps + 1
  // (ps only where ps + 1 == pt); row t holds ceil(t / 2) tiles, 256 in all.
  int pt = 1, base = 0;
  while (base + (pt + 1) / 2 <= tid) {
    base += (pt + 1) / 2;
    ++pt;
  }
  const int ps = 2 * (tid - base);
  const bool half = ps + 1 == pt;
  const int ps1 = half ? ps : ps + 1;
  // warps 0-3: a 4 (t) x 4 (v) tile of y; warps 4-7: an 8 (k) x 4 (v) tile of S
  const bool ywarp = tid < kThreadsWkv / 2;
  const int q = tid % (kThreadsWkv / 2);
  const int t0 = 4 * (q >> 4), kk0 = 8 * (q >> 4), v0 = 4 * (q & 15);

  for (long long c0 = cs;; c0 += kChunk) {
    const bool more = c0 + kChunk < cs + kL && c0 + kChunk < a.s;
    {
      ChunkLoad<T, kVec, true> ld;
      ld.load(rp, kp, vp, wp, a, c0);
      ld.store(sm.r, sm.k, sm.v, sm.lx);
    }
    if (more) prefetch_chunk(rp, kp, vp, wp, a, c0 + kChunk);
    __syncthreads();
    if (tid < kKMax) {
      // a lane per key channel: the cumsum in order
      float run = 0.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        const float l = sm.lx[t][tid];
        run += l;
        sm.lw[t][tid] = run;
        sm.lx[t][tid] = run - l;
      }
    } else if (tid < kKMax + kChunk) {
      // A's diagonal, r . (u * k)
      const int t = tid - kKMax;
      float acc = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kKMax; kk += 4) {
        const float4 r4 = ld4(&sm.r[t][kk]), k4 = ld4(&sm.k[t][kk]), u4 = ld4(&sm.u[kk]);
        acc = fmaf(r4.x * k4.x, u4.x, acc);
        acc = fmaf(r4.y * k4.y, u4.y, acc);
        acc = fmaf(r4.z * k4.z, u4.z, acc);
        acc = fmaf(r4.w * k4.w, u4.w, acc);
      }
      sm.a[t][t] = acc;
    }
    __syncthreads();
    {
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kKMax; kk += 4) {
        const float4 r4 = ld4(&sm.r[pt][kk]), x4 = ld4(&sm.lx[pt][kk]);
        const float4 k04 = ld4(&sm.k[ps][kk]), l04 = ld4(&sm.lw[ps][kk]);
        const float4 k14 = ld4(&sm.k[ps1][kk]), l14 = ld4(&sm.lw[ps1][kk]);
        acc0 = fmaf(r4.x * k04.x, expf(x4.x - l04.x), acc0);
        acc0 = fmaf(r4.y * k04.y, expf(x4.y - l04.y), acc0);
        acc0 = fmaf(r4.z * k04.z, expf(x4.z - l04.z), acc0);
        acc0 = fmaf(r4.w * k04.w, expf(x4.w - l04.w), acc0);
        acc1 = fmaf(r4.x * k14.x, expf(x4.x - l14.x), acc1);
        acc1 = fmaf(r4.y * k14.y, expf(x4.y - l14.y), acc1);
        acc1 = fmaf(r4.z * k14.z, expf(x4.z - l14.z), acc1);
        acc1 = fmaf(r4.w * k14.w, expf(x4.w - l14.w), acc1);
      }
      sm.a[pt][ps] = acc0;
      if (!half) sm.a[pt][ps + 1] = acc1;
    }
    __syncthreads();
    // in place: r * exp(lx) for the state term, k * exp(lw_last - lw) for
    // the state update
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreadsWkv, t = e >> 4, c = 4 * (e & 15);
      const float4 r4 = ld4(&sm.r[t][c]), x4 = ld4(&sm.lx[t][c]);
      const float4 k4 = ld4(&sm.k[t][c]), l4 = ld4(&sm.lw[t][c]), z4 = ld4(&sm.lw[kChunk - 1][c]);
      st4(&sm.r[t][c], make_float4(r4.x * expf(x4.x), r4.y * expf(x4.y), r4.z * expf(x4.z),
                                   r4.w * expf(x4.w)));
      st4(&sm.k[t][c], make_float4(k4.x * expf(z4.x - l4.x), k4.y * expf(z4.y - l4.y),
                                   k4.z * expf(z4.z - l4.z), k4.w * expf(z4.w - l4.w)));
    }
    if (tid < kKMax) sm.e[tid] = expf(sm.lw[kChunk - 1][tid]);
    __syncthreads();
    float nst[8][4] = {};
    if (ywarp) {
      // y = (r * exp(lx)) . S_prev + A v
      float acc[4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kKMax; kk += 4) {
        float rv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 r4 = ld4(&sm.r[t0 + i][kk]);
          rv[i][0] = r4.x; rv[i][1] = r4.y; rv[i][2] = r4.z; rv[i][3] = r4.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 s4 = ld4(&sm.st[kk + j][v0]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(rv[i][j], s4.x, acc[i][0]);
            acc[i][1] = fmaf(rv[i][j], s4.y, acc[i][1]);
            acc[i][2] = fmaf(rv[i][j], s4.z, acc[i][2]);
            acc[i][3] = fmaf(rv[i][j], s4.w, acc[i][3]);
          }
        }
      }
      // A is zero above the diagonal: s stops at the tile's last row
      for (int s = 0; s < t0 + 4; s += 4) {
        float av[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a4 = ld4(&sm.a[t0 + i][s]);
          av[i][0] = a4.x; av[i][1] = a4.y; av[i][2] = a4.z; av[i][3] = a4.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 x4 = ld4(&sm.v[s + j][v0]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(av[i][j], x4.x, acc[i][0]);
            acc[i][1] = fmaf(av[i][j], x4.y, acc[i][1]);
            acc[i][2] = fmaf(av[i][j], x4.z, acc[i][2]);
            acc[i][3] = fmaf(av[i][j], x4.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long pos = c0 + t0 + i;
        if (pos < a.s)
          store4<kVec>(yp + pos * a.yss, v0, vd,
                       make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    } else if (more) {
      // S_new = diag(exp(lw_last)) S_prev + (k * exp(lw_last - lw))^T v
#pragma unroll 4
      for (int s = 0; s < kChunk; ++s) {
        const float4 ka = ld4(&sm.k[s][kk0]), kb = ld4(&sm.k[s][kk0 + 4]), x4 = ld4(&sm.v[s][v0]);
        const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          nst[i][0] = fmaf(kv[i], x4.x, nst[i][0]);
          nst[i][1] = fmaf(kv[i], x4.y, nst[i][1]);
          nst[i][2] = fmaf(kv[i], x4.z, nst[i][2]);
          nst[i][3] = fmaf(kv[i], x4.w, nst[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = sm.e[kk0 + i];
        const float4 s4 = ld4(&sm.st[kk0 + i][v0]);
        nst[i][0] = fmaf(e, s4.x, nst[i][0]);
        nst[i][1] = fmaf(e, s4.y, nst[i][1]);
        nst[i][2] = fmaf(e, s4.z, nst[i][2]);
        nst[i][3] = fmaf(e, s4.w, nst[i][3]);
      }
    }
    if (!more) break;
    __syncthreads();    // every read of this inner chunk is done
    if (!ywarp) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st4(&sm.st[kk0 + i][v0], make_float4(nst[i][0], nst[i][1], nst[i][2], nst[i][3]));
    }
  }
}

template <typename T, bool kVec>
int launch(const WkvArgs& a, cudaStream_t stream) {
  const long long blocks = a.b * a.h * a.nc;
  const int pw = a.vd % 4 == 0 ? 4 : 1;    // state elements per thread in the pass
  const long long per_bh = (a.kd * a.vd / pw + kThreadsWkv - 1) / kThreadsWkv;
  if (blocks > INT_MAX || a.b * a.h * per_bh > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (blocks > 0) {
    rwkv6_chunked_state_kernel<T, kVec>
        <<<static_cast<unsigned>(blocks), kThreadsWkv, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned pass_blocks = static_cast<unsigned>(a.b * a.h * per_bh);
  if (pw == 4)
    rwkv6_chunked_pass_kernel<4><<<pass_blocks, kThreadsWkv, 0, stream>>>(
        a.dstate, a.gdec, a.state, a.kd, a.vd, a.nc, per_bh);
  else
    rwkv6_chunked_pass_kernel<1><<<pass_blocks, kThreadsWkv, 0, stream>>>(
        a.dstate, a.gdec, a.state, a.kd, a.vd, a.nc, per_bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    const int smem = static_cast<int>(sizeof(OutSmem));
    err = cudaFuncSetAttribute(rwkv6_chunked_out_kernel<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rwkv6_chunked_out_kernel<T, kVec>
        <<<static_cast<unsigned>(blocks), kThreadsWkv, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of 4-element vectors: the base is aligned to 4 elements and every
// stride is a multiple of 4.
bool vec_rows(const void* base, int esize, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(base) % (4 * esize) == 0 && sb % 4 == 0 && sh % 4 == 0 &&
         ss % 4 == 0;
}

}  // namespace

// meta: b, h, s, kd, vd, then the strides in elements (batch, head, pos) of
// r, k, v, w and y. dtype of r, k, v and y: 0 float32, 1 bfloat16. u: (h, kd)
// float32, contiguous. state: (b, h, kd, vd) float32, contiguous. scratch:
// float32, at least b*h*nc*(kd*vd + kd) elements with nc = ceil(s / 128).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for kd or vd outside
// [1, 64], an unknown dtype or a grid too large.
extern "C" int repro_rwkv6_chunked(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, void* y, void* state, void* scratch,
                                   const long long* meta, int dtype, int device, void* stream) {
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
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.b <= 0 || a.h <= 0) return static_cast<int>(cudaGetLastError());
  a.nc = (a.s + kL - 1) / kL;
  a.dstate = static_cast<float*>(scratch);
  a.gdec = a.dstate + a.b * a.h * a.nc * a.kd * a.vd;
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = a.kd % 4 == 0 && a.vd % 4 == 0 &&
                   vec_rows(r, esize, a.rsb, a.rsh, a.rss) &&
                   vec_rows(k, esize, a.ksb, a.ksh, a.kss) &&
                   vec_rows(v, esize, a.vsb, a.vsh, a.vss) &&
                   vec_rows(w, 4, a.wsb, a.wsh, a.wss) &&
                   vec_rows(y, esize, a.ysb, a.ysh, a.yss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return vec ? launch<float, true>(a, st) : launch<float, false>(a, st);
  return vec ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
}
