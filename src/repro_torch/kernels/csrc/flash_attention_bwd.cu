// flash_attention_bwd: the training backward of causal bf16 attention at head
// dim 64, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its flash attention
// through custom_vjp, whose backward (src/repro/models/attention.py::
// _flash_vjp_bwd) is jnp einsums that XLA compiles. The port's plain twin of
// that backward, torch ops in float32, is repro_torch.models.attention.
// _flash_bwd; _Flash.backward launches this kernel pair instead for the
// inputs it takes (CUDA bf16, D = 64, causal with or without a window, GQA,
// S == T) and the twin for every other form.
//
// What it computes is the twin's function, row-sum repair included: each
// row's normaliser P = sum_j p_ij and sum_j p_ij dp_ij come from the scores
// recomputed here, never from the forward's output, so every row of
// dS = p/P (dP - dsum) sums to zero up to its own float32 rounding; then
// dq = scale dS K, dk = scale dS^T Q and dv = (p/P)^T dO. p = exp(scale s -
// lse) with the forward's log-sum-exp; masked pairs (key after the query, or
// the query's window passed) have p = 0. Any (batch, head, position) strides
// with a contiguous head dim, 16-B aligned (the forward's TMA rule); KV head
// = q head * Hkv / Hq.
//
// Bound: five products of 2*D flops for every unmasked (query, key) pair
// (S, dP, dV, dK, dQ): 10*D flops a pair at the tensor cores' 989 TFLOP/s.
// At hymba-1.5b's training shape (B = 8, S = 2048, 25 query / 5 KV heads, 29
// layers with a window of 1024 and 3 full causal) that is 6.65 TFLOP a step,
// 6.7 ms.
//
// Design: two launches on mma.sync.m16n8k16 (bf16 operands, fp32
// accumulators), tiles of 64 query rows and 64 keys, every operand tile in
// shared memory as 128-B rows with their 16-B chunks XOR-swizzled by
// row % 8, read by ldmatrix (transposed where a product needs the other
// major order) and filled by cp.async one tile ahead of its use. Only the
// tiles inside the causal frontier and the window are visited, and only the
// diagonal, window-edge and ragged tiles are masked. Each warp works on half
// a tile (32 columns) at a time, so registers are capped at 168 for three
// blocks of four warps an SM (ptxas: a few dozen bytes spilled).
//  1. flash_bwd_dq_kernel, one block of four warps per (query tile, q head,
//     batch row), the longest rows first; each warp owns 16 rows with their
//     Q and dO fragments in registers. Sweep 1 over the key tiles recomputes
//     S = Q K^T and dP = dO V^T and sums P and P dP per row; the block writes
//     inv = 1/P and dsum = (P dP)/P (fp32, (B, Hq, S)). Sweep 2 recomputes
//     the same S and dP (the same instructions in the same order, so the
//     same P and dP bit for bit), forms dS and accumulates dQ = dS K in fp32
//     registers. dS enters that product as a hi/lo pair of bf16,
//     dS_hi = bf16(dS) and dS_lo = bf16(dS - dS_hi): dQ multiplies K's common
//     part by each row's sum of dS, which the repair makes zero in fp32, and
//     one bf16 rounding of dS leaves 2^-9 of it (the forward's P uses the
//     same pair for its early, peaky rows).
//  2. flash_bwd_dkdv_kernel, one block of four warps per (key tile, KV head,
//     batch row), the longest columns first; each warp owns 16 keys and
//     keeps their dK and dV in fp32 registers while it walks the G query
//     heads of its group and their query tiles inside the frontier, so GQA
//     needs no atomics and dQ no scratch. It recomputes S^T = K Q^T and
//     dP^T = V dO^T, reads each query's lse, inv and dsum from shared memory,
//     and accumulates dV += (P/P_row)^T dO and dK += dS^T Q with P and dS as
//     single bf16 operands (no sum over the key's queries is repaired).
// Products: S and dP twice in (1), dQ with the pair twice, four in (2):
// 20*D flops a pair against the bound's 10*D, a floor of 13.4 ms a hymba
// step. No dq is accumulated by atomics, so the gradients are the same bits
// on every run.
//
// On an H100 80GB HBM3 at 700 W (copies of this file, each changed in one
// point, timed at hymba's shape and held to float64) a hymba step's
// 29 windowed and 3 full calls took 57.1-59.0 device ms (11.4-11.8% of the
// bound): a windowed call 1.05-1.09 ms in (1) and 0.69-0.71 in (2). Measured
// and not kept: dS as one bf16 in dQ (dq 22-35 times the float64 bound on
// near-uniform rows, 1-5% faster); registers for two blocks an SM (64.8 ms);
// the whole tile's S and dP live at once (64.2-67.2 ms); mma.sync without
// volatile (no change); blocks ordered head by head for L2 reuse (61-64 ms).
// A warp's 16 rows make each B fragment (one ldmatrix.x4) feed two mma.sync,
// so shared-memory reads pace the tensor cores: each product runs at about a
// quarter of the card's bf16 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kD = 64;           // head dim
constexpr int kTile = 64;        // query rows and keys a tile
constexpr int kThreads = 128;    // four warps of 16 rows (dq) or 16 keys (dk, dv)
constexpr int kTileElems = kTile * kD;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqBlocks = 3;     // blocks an SM holds: registers capped at 65,536 / (128 x 3)
constexpr int kDkdvBlocks = 3;

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;     // (B, Hq, S) contiguous: the forward's natural-log log-sum-exp
  float* inv;           // (B, Hq, S) contiguous: 1 / sum_j p_ij, written by (1)
  float* dsum;          // (B, Hq, S) contiguous: sum_j p_ij dp_ij / sum_j p_ij
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, hq, hkv, s, n_tiles;
  int window;           // <= 0: no window
  float scale;          // 1/sqrt(D)
  // (batch, head, position) strides in elements
  long long qs[3], ks[3], vs[3], os[3], dqs[3], dks[3], dvs[3];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-B chunk `chunk` of row `row` in a 64 x 64 bf16 tile:
// rows of 128 B, chunks XOR-swizzled by row % 8, so the eight rows one
// ldmatrix phase reads lie in eight different bank groups.
__device__ __forceinline__ int sw(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

// cp.async of 16 (or 4) bytes; with valid false the destination is zero
// filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Rows [row0, row0 + 64) of one (batch, head) of a strided tensor into a
// swizzled tile; rows at or past s read as zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int row0, int s, int tid) {
#pragma unroll
  for (int i = 0; i < kTileElems / 8 / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int row = e >> 3, chunk = e & 7;
    const bool ok = row0 + row < s;
    cp_async16(dst + sw(row, chunk), src + (ok ? row0 + row : 0) * ss + chunk * 8, ok);
  }
}

// 64 floats of a row statistic from (B, Hq, S) rows [row0, row0 + 64), zero past s.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int s, int tid) {
  if (tid < kTile) {
    const bool ok = row0 + tid < s;
    cp_async4(dst + tid, src + (ok ? row0 + tid : 0), ok);
  }
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// The A fragment (16 rows from m0, 16 columns of k-step kk) of a row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int m0,
                                       int kk, int lane) {
  ldsm(a, tile + sw(m0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4)));
}
// B fragments of n-tiles n0 and n0 + 8 at k-step kk, from a tile stored
// [n][k] (B = tile^T): b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                       int kk, int lane) {
  ldsm(b, tile + sw(n0 + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1)));
}
// The same from a tile stored [k][n] (B = tile), by transposing loads.
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                         int kk, int lane) {
  ldsm_t(b, tile + sw(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, n0 / 8 + (lane >> 4)));
}

// C (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 32) += A (16 x 64, four k-steps in registers) times rows
// [n0, n0 + 32) of the tile^T (B stored [n][k]).
__device__ __forceinline__ void product_nt(float (&acc)[4][4], const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* tile, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      frag_b(b, tile, n0 + 16 * np, kk, lane);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of k-step kk from a 16 x 32 accumulator (its n-tiles 2kk
// and 2kk + 1): the accumulator layout of 16 columns is the A layout.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[4][4], int kk) {
  a[0] = pack(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// The same as a hi/lo pair: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&acc)[4][4], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* c = acc[2 * kk + r / 2] + 2 * (r % 2);
    const __nv_bfloat162 h = __floats2bfloat162_rn(c[0], c[1]);
    const float2 hf = __bfloat1622float2(h);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack(c[0] - hf.x, c[1] - hf.y);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
}

// Whether the pair (query i, key j) is unmasked: causal and inside the window.
__device__ __forceinline__ bool unmasked(int i, int j, int window) {
  return j <= i && (window <= 0 || i - j < window);
}

// ---------------------------------------------------------------------------
// (1) row statistics, then dQ
// ---------------------------------------------------------------------------

struct DqSmem {
  __nv_bfloat16 q[kTileElems];
  __nv_bfloat16 dout[kTileElems];
  __nv_bfloat16 k[2][kTileElems];
  __nv_bfloat16 v[2][kTileElems];
};

__global__ void __launch_bounds__(kThreads, kDqBlocks) flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the longest query tiles first, every (batch row, q head) of a tile rank together
  const int w = static_cast<int>(blockIdx.x);
  const int qt = a.n_tiles - 1 - w / (a.hq * a.b);
  const int hi = w % (a.hq * a.b) % a.hq;
  const int bi = w % (a.hq * a.b) / a.hq;
  const int hk = hi / (a.hq / a.hkv);
  const int q0 = qt * kTile;
  const __nv_bfloat16* qp = a.q + bi * a.qs[0] + hi * a.qs[1];
  const __nv_bfloat16* op = a.dout + bi * a.os[0] + hi * a.os[1];
  const __nv_bfloat16* kp = a.k + bi * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vp = a.v + bi * a.vs[0] + hk * a.vs[1];
  // key tiles from the one holding the window's first key to the diagonal
  int t_lo = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) t_lo = (q0 - a.window + 1) / kTile;
  const int n = qt + 1 - t_lo;

  load_tile(sm.q, qp, a.qs[2], q0, a.s, tid);
  load_tile(sm.dout, op, a.os[2], q0, a.s, tid);
  cp_commit();
  load_tile(sm.k[0], kp, a.ks[2], t_lo * kTile, a.s, tid);
  load_tile(sm.v[0], vp, a.vs[2], t_lo * kTile, a.s, tid);
  cp_commit();
  cp_wait1();
  __syncthreads();
  const int m0 = 16 * warp;
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(qa[kk], sm.q, m0, kk, lane);
    frag_a(da[kk], sm.dout, m0, kk, lane);
  }
  // this thread's two rows (the accumulator layout) and its first column of
  // every 8
  const int r0 = q0 + m0 + (lane >> 2), r1 = r0 + 8;
  const int col = 2 * (lane & 3);
  const long long rows = (static_cast<long long>(bi) * a.hq + hi) * a.s;
  const float c = a.scale * kLog2e;
  const float l0 = r0 < a.s ? a.lse[rows + r0] * kLog2e : 0.f;
  const float l1 = r1 < a.s ? a.lse[rows + r1] * kLog2e : 0.f;
  float p0 = 0.f, p1 = 0.f, pd0 = 0.f, pd1 = 0.f;   // sweep 1: partial sums of P and P dP
  float inv0 = 0.f, inv1 = 0.f, ds0 = 0.f, ds1 = 0.f;
  float dq[8][4];
  zero(dq);

  for (int it = 0; it < 2 * n; ++it) {
    const int st = it & 1;
    const int j = it < n ? it : it - n;
    if (it + 1 < 2 * n) {        // the next tile, the first again when sweep 2 starts
      const int jn = (it + 1 < n ? it + 1 : it + 1 - n) + t_lo;
      load_tile(sm.k[st ^ 1], kp, a.ks[2], jn * kTile, a.s, tid);
      load_tile(sm.v[st ^ 1], vp, a.vs[2], jn * kTile, a.s, tid);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int k0 = (t_lo + j) * kTile;
    const bool edge = k0 == q0 || (a.window > 0 && q0 + kTile - 1 - k0 >= a.window);
    // the tile's keys in two halves of 32, each as S = Q K^T and dP = dO V^T
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      product_nt(s, qa, sm.k[st], 32 * half, lane);
      product_nt(dp, da, sm.v[st], 32 * half, lane);
      // p = exp(scale s - lse), masked pairs 0; sweep 1 sums it, sweep 2 forms dS in s
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[nt][e], c, -(e < 2 ? l0 : l1)));
          if (edge && !unmasked(e < 2 ? r0 : r1, k0 + 32 * half + 8 * nt + col + (e & 1),
                                a.window))
            p = 0.f;
          if (it < n) {
            if (e < 2) {
              p0 += p;
              pd0 += p * dp[nt][e];
            } else {
              p1 += p;
              pd1 += p * dp[nt][e];
            }
          } else {
            const float pn = p * (e < 2 ? inv0 : inv1);
            s[nt][e] = (dp[nt][e] - (e < 2 ? ds0 : ds1)) * pn;
          }
        }
      }
      if (it >= n) {             // dQ += dS K, dS as a hi/lo pair, K read [key][dim]
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ah[4], al[4];
          acc_to_a_split(ah, al, s, kk);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            frag_b_t(b, sm.k[st], 16 * np, 2 * half + kk, lane);
            mma(dq[2 * np], ah, b[0], b[1]);
            mma(dq[2 * np + 1], ah, b[2], b[3]);
            mma(dq[2 * np], al, b[0], b[1]);
            mma(dq[2 * np + 1], al, b[2], b[3]);
          }
        }
      }
    }
    if (it == n - 1) {           // the rows' statistics, reduced over their quads
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, off);
        p1 += __shfl_xor_sync(0xffffffffu, p1, off);
        pd0 += __shfl_xor_sync(0xffffffffu, pd0, off);
        pd1 += __shfl_xor_sync(0xffffffffu, pd1, off);
      }
      inv0 = 1.f / p0;
      inv1 = 1.f / p1;
      ds0 = pd0 * inv0;
      ds1 = pd1 * inv1;
      if ((lane & 3) == 0) {
        if (r0 < a.s) {
          a.inv[rows + r0] = inv0;
          a.dsum[rows + r0] = ds0;
        }
        if (r1 < a.s) {
          a.inv[rows + r1] = inv1;
          a.dsum[rows + r1] = ds1;
        }
      }
    }
    __syncthreads();             // the tile is consumed before it is refilled
  }

  __nv_bfloat16* dqp = a.dq + bi * a.dqs[0] + hi * a.dqs[1];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = 8 * nt + col;
    if (r0 < a.s)
      *reinterpret_cast<__nv_bfloat162*>(dqp + r0 * a.dqs[2] + d) =
          __floats2bfloat162_rn(dq[nt][0] * a.scale, dq[nt][1] * a.scale);
    if (r1 < a.s)
      *reinterpret_cast<__nv_bfloat162*>(dqp + r1 * a.dqs[2] + d) =
          __floats2bfloat162_rn(dq[nt][2] * a.scale, dq[nt][3] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// (2) dK and dV
// ---------------------------------------------------------------------------

struct DkdvSmem {
  __nv_bfloat16 k[kTileElems];
  __nv_bfloat16 v[kTileElems];
  __nv_bfloat16 q[2][kTileElems];
  __nv_bfloat16 dout[2][kTileElems];
  float lse[2][kTile];
  float inv[2][kTile];
  float dsum[2][kTile];
};

__global__ void __launch_bounds__(kThreads, kDkdvBlocks) flash_bwd_dkdv_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the longest key tiles first, every (batch row, KV head) of a tile rank together
  const int w = static_cast<int>(blockIdx.x);
  const int kt = w / (a.hkv * a.b);
  const int hk = w % (a.hkv * a.b) % a.hkv;
  const int bi = w % (a.hkv * a.b) / a.hkv;
  const int g = a.hq / a.hkv;
  const int k0 = kt * kTile;
  // query tiles from the diagonal to the one holding the window's last query
  int t_hi = a.n_tiles - 1;
  if (a.window > 0) {
    const long long last = static_cast<long long>(k0) + kTile - 1 + a.window - 1;
    if (last / kTile < t_hi) t_hi = static_cast<int>(last / kTile);
  }
  const int m = t_hi - kt + 1;
  const int n = g * m;           // (query head, query tile) pairs

  // the pair it's tiles: Q, dO and the rows' lse, inv and dsum
  auto load_pair = [&](int it, int buf) {
    const int h = hk * g + it / m;
    const int q0 = (kt + it % m) * kTile;
    load_tile(sm.q[buf], a.q + bi * a.qs[0] + h * a.qs[1], a.qs[2], q0, a.s, tid);
    load_tile(sm.dout[buf], a.dout + bi * a.os[0] + h * a.os[1], a.os[2], q0, a.s, tid);
    const long long rows = (static_cast<long long>(bi) * a.hq + h) * a.s;
    load_rows(sm.lse[buf], a.lse + rows, q0, a.s, tid);
    load_rows(sm.inv[buf], a.inv + rows, q0, a.s, tid);
    load_rows(sm.dsum[buf], a.dsum + rows, q0, a.s, tid);
  };
  load_tile(sm.k, a.k + bi * a.ks[0] + hk * a.ks[1], a.ks[2], k0, a.s, tid);
  load_tile(sm.v, a.v + bi * a.vs[0] + hk * a.vs[1], a.vs[2], k0, a.s, tid);
  load_pair(0, 0);
  cp_commit();

  const int m0 = 16 * warp;
  // this thread's two keys (the accumulator's rows) and its first query
  // column of every 8
  const int j0 = k0 + m0 + (lane >> 2), j1 = j0 + 8;
  const int col = 2 * (lane & 3);
  const float c = a.scale * kLog2e;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    if (it + 1 < n) load_pair(it + 1, st ^ 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int q0 = (kt + it % m) * kTile;
    const bool edge = q0 == k0 || q0 + kTile > a.s ||
                      (a.window > 0 && q0 + kTile - 1 - k0 >= a.window);
    // the tile's queries in two halves of 32: S^T = K Q^T and dP^T = V dO^T
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ka[4], va[4];
        frag_a(ka, sm.k, m0, kk, lane);
        frag_a(va, sm.v, m0, kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          frag_b(b, sm.q[st], 32 * half + 16 * np, kk, lane);
          mma(s[2 * np], ka, b[0], b[1]);
          mma(s[2 * np + 1], ka, b[2], b[3]);
          frag_b(b, sm.dout[st], 32 * half + 16 * np, kk, lane);
          mma(dp[2 * np], va, b[0], b[1]);
          mma(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      // s: p / P of each (key, query); dp: dS
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 32 * half + 8 * nt + col + (e & 1);
          float p = ex2(fmaf(s[nt][e], c, -sm.lse[st][qi] * kLog2e));
          if (edge && !(q0 + qi < a.s && unmasked(q0 + qi, e < 2 ? j0 : j1, a.window))) p = 0.f;
          const float pn = p * sm.inv[st][qi];
          s[nt][e] = pn;
          dp[nt][e] = (dp[nt][e] - sm.dsum[st][qi]) * pn;
        }
      }
      // dV += P^T dO, dK += dS^T Q: k over the half's queries, dO and Q read [query][dim]
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], ad[4];
        acc_to_a(ap, s, kk);
        acc_to_a(ad, dp, kk);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          frag_b_t(b, sm.dout[st], 16 * np, 2 * half + kk, lane);
          mma(dv[2 * np], ap, b[0], b[1]);
          mma(dv[2 * np + 1], ap, b[2], b[3]);
          frag_b_t(b, sm.q[st], 16 * np, 2 * half + kk, lane);
          mma(dk[2 * np], ad, b[0], b[1]);
          mma(dk[2 * np + 1], ad, b[2], b[3]);
        }
      }
    }
    __syncthreads();             // the pair's tiles are consumed before they are refilled
  }

  __nv_bfloat16* dkp = a.dk + bi * a.dks[0] + hk * a.dks[1];
  __nv_bfloat16* dvp = a.dv + bi * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = 8 * nt + col;
    if (j0 < a.s) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + j0 * a.dks[2] + d) =
          __floats2bfloat162_rn(dk[nt][0] * a.scale, dk[nt][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + j0 * a.dvs[2] + d) =
          __floats2bfloat162_rn(dv[nt][0], dv[nt][1]);
    }
    if (j1 < a.s) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + j1 * a.dks[2] + d) =
          __floats2bfloat162_rn(dk[nt][2] * a.scale, dk[nt][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + j1 * a.dvs[2] + d) =
          __floats2bfloat162_rn(dv[nt][2], dv[nt][3]);
    }
  }
}

// Once per device: allow both kernels their dynamic shared memory.
cudaError_t prepare() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sizeof(DqSmem)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(DkdvSmem)));
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

}  // namespace

// meta: b, hq, hkv, s (= t), then the (batch, head, position) strides in
// elements of q, k, v, dout, dq, dk and dv. lse: the forward's contiguous
// float32 (B, Hq, S) log-sum-exp; inv and dsum: float32 (B, Hq, S) scratch
// that the first launch fills and the second reads. Causal attention at
// head dim 64 in bfloat16 only, with window <= 0 for none. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for head counts that do not
// group or sizes past the kernels' int indexing.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, float* inv,
                                         float* dsum, void* dq, void* dk, void* dv,
                                         const long long* meta, int window, float scale,
                                         int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = lse; a.inv = inv; a.dsum = dsum;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  const long long b = meta[0], hq = meta[1], hkv = meta[2], s = meta[3];
  long long* strides[7] = {a.qs, a.ks, a.vs, a.os, a.dqs, a.dks, a.dvs};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = meta[4 + 3 * t + i];
  if (b <= 0 || hq <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const long long n_tiles = (s + kTile - 1) / kTile;
  if (hkv <= 0 || hq % hkv || s > (1LL << 30) || n_tiles * hq * b > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  a.b = static_cast<int>(b); a.hq = static_cast<int>(hq); a.hkv = static_cast<int>(hkv);
  a.s = static_cast<int>(s); a.n_tiles = static_cast<int>(n_tiles);
  a.window = window; a.scale = scale;
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<<<static_cast<unsigned>(n_tiles * hq * b), kThreads, sizeof(DqSmem), st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_kernel<<<static_cast<unsigned>(n_tiles * hkv * b), kThreads, sizeof(DkdvSmem),
                          st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
