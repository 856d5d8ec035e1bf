// flash_attention: the GQA attention forward of the LLM prefill, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention_fwd (pallas_call at flash_attention.py:137), whose body
// (flash_attention.py:38-97) it computes: q scaled by 1/sqrt(D) in fp32,
// scores in fp32, the tanh softcap before masking, the causal mask
// q_pos >= k_pos and the window mask q_pos - k_pos < window (masked scores
// are -1e30, as in the TPU kernel), an online max/sum in fp32, and the output
// acc / max(l, 1e-30) cast to q's type. KV head = q_head * Hkv / Hq. The main
// path reaches it through repro_torch.models.attention.attend (every prefill
// layer of the LLM).
//
// Design: one block per (batch, q head, tile of 64 query rows). Each query row
// is owned by G = D/32 neighbouring threads; a thread holds 32 of the row's D
// dims of q (pre-scaled) and of the fp32 accumulator in registers, in float4
// groups interleaved across the G threads, so a warp's shared-memory reads of
// one key row are G neighbouring float4s broadcast to every row. K and V tiles
// are staged in shared memory as fp32; a row's dot product is reduced across
// its G threads with warp shuffles. The online softmax takes 16 keys at a
// time. KV tiles past the tile's causal frontier or wholly before its window
// are never loaded (the TPU kernel's pl.when skip). S and T need not be
// multiples of the tiles: query rows past S are computed but not stored, and
// keys past T are masked like any other.
//
// Layout: any strides for (batch, head, position); the head dim must be
// contiguous. The model passes its (B, S, H, D) tensors as (B, H, S, D) views,
// so nothing is transposed in memory.
//
// Bound: operations. 4*D flops per unmasked (query, key) pair against bytes
// that read q, k, v and write o once. This first version runs on the fp32
// CUDA cores (no tensor cores), so it sits far above the bf16 bound;
// wgmma/TMA tiles are later work.

#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;     // query rows per block
constexpr int kKSub = 16;   // keys per online-softmax step

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long b, hq, hkv, s, t;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no softcap
  float scale;
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
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ * (D / 32))
flash_fwd_kernel(const FlashArgs a) {
  constexpr int G = D / 32;                 // threads per query row
  constexpr int BK = D == 64 ? 64 : 32;     // keys per shared-memory tile
  constexpr int NT = kBQ * G;
  constexpr int V4 = 8;                     // float4 groups per thread (32 dims)
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / G;
  const int g = tid % G;
  const long long bi = blockIdx.z, hi = blockIdx.y;
  const long long hk = hi * a.hkv / a.hq;
  const long long q0 = (long long)blockIdx.x * kBQ;
  const long long qpos = q0 + row;
  const bool qvalid = qpos < a.s;

  const T* qp = static_cast<const T*>(a.q) + bi * a.qsb + hi * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + bi * a.ksb + hk * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.vsb + hk * a.vsh;

  // this thread's dims: float4 group (i * G + g) for i in [0, 8)
  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < V4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = (i * G + g) * 4 + c;
      qr[i * 4 + c] = qvalid ? to_f(qp[qpos * a.qss + d]) * a.scale : 0.f;
      acc[i * 4 + c] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const long long q_last = (q0 + kBQ < a.s ? q0 + kBQ : a.s) - 1;
  long long k_end = a.t;
  if (a.causal && q_last + 1 < k_end) k_end = q_last + 1;
  long long k_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) k_begin = q0 - a.window + 1;
  k_begin = (k_begin / BK) * BK;

  for (long long kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // the previous tile is consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      const long long kpos = kt + j;
      float kx = 0.f, vx = 0.f;
      if (kpos < a.t) {
        kx = to_f(kp[kpos * a.kss + d]);
        vx = to_f(vp[kpos * a.vss + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += kKSub) {
      float p[kKSub];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kKSub; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < V4; ++i) {
          const float4 kv = kr[i * G + g];
          part = fmaf(qr[i * 4 + 0], kv.x, part);
          part = fmaf(qr[i * 4 + 1], kv.y, part);
          part = fmaf(qr[i * 4 + 2], kv.z, part);
          part = fmaf(qr[i * 4 + 3], kv.w, part);
        }
#pragma unroll
        for (int off = 1; off < G; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (a.softcap > 0.f) part = a.softcap * tanhf(part / a.softcap);
        const long long kpos = kt + j0 + jj;
        bool ok = kpos < a.t;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window > 0) ok = ok && qpos - kpos < a.window;
        p[jj] = ok ? part : kNegInf;
        mx = fmaxf(mx, p[jj]);
      }
      const float alpha = expf(m - mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKSub; ++jj) {
        p[jj] = expf(p[jj] - mx);
        psum += p[jj];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kKSub; ++jj) {
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
        for (int i = 0; i < V4; ++i) {
          const float4 vv = vr[i * G + g];
          acc[i * 4 + 0] = fmaf(p[jj], vv.x, acc[i * 4 + 0]);
          acc[i * 4 + 1] = fmaf(p[jj], vv.y, acc[i * 4 + 1]);
          acc[i * 4 + 2] = fmaf(p[jj], vv.z, acc[i * 4 + 2]);
          acc[i * 4 + 3] = fmaf(p[jj], vv.w, acc[i * 4 + 3]);
        }
      }
      m = mx;
    }
  }

  if (qvalid) {
    T* op = static_cast<T*>(a.o) + bi * a.osb + hi * a.osh + qpos * a.oss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < V4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        op[(i * G + g) * 4 + c] = from_f<T>(acc[i * 4 + c] / den);
      }
    }
  }
}

template <typename T, int D>
void launch(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((a.s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.hq), static_cast<unsigned>(a.b));
  flash_fwd_kernel<T, D><<<grid, kBQ * (D / 32), 0, st>>>(a);
}

}  // namespace

// meta: b, hq, hkv, s, t, then the (batch, head, position) strides in
// elements of q, k, v and o. dtype: 0 float32, 1 bfloat16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim other than 64
// or 128 or an unknown dtype.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, const long long* meta, int dtype,
                                     int head_dim, int causal, int window,
                                     float softcap, float scale, void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.b = meta[0]; a.hq = meta[1]; a.hkv = meta[2]; a.s = meta[3]; a.t = meta[4];
  a.qsb = meta[5]; a.qsh = meta[6]; a.qss = meta[7];
  a.ksb = meta[8]; a.ksh = meta[9]; a.kss = meta[10];
  a.vsb = meta[11]; a.vsh = meta[12]; a.vss = meta[13];
  a.osb = meta[14]; a.osh = meta[15]; a.oss = meta[16];
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  if (a.b <= 0 || a.hq <= 0 || a.s <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) launch<float, 64>(a, st);
  else if (dtype == 0 && head_dim == 128) launch<float, 128>(a, st);
  else if (dtype == 1 && head_dim == 64) launch<__nv_bfloat16, 64>(a, st);
  else if (dtype == 1 && head_dim == 128) launch<__nv_bfloat16, 128>(a, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
