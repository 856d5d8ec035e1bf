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
// layer of the LLM). One C entry point, repro_flash_attention, picks one of
// two kernels by dtype. Both take any strides for (batch, head, position)
// with a contiguous head dim, so the model's (B, S, H, D) tensors go in as
// (B, H, S, D) views, and both skip the KV tiles past a query tile's causal
// frontier or wholly before its window (the TPU kernel's pl.when skip).
// Given a non-null lse pointer, both also write each row's natural-log
// log-sum-exp in their epilogue, one float per row: the softmax statistics
// from which the training backward (repro_torch.models.attention._Flash)
// recomputes P. With a null pointer nothing else changes.
//
// Bound: operations, 4*D flops per unmasked (query, key) pair, against bytes
// that read q, k, v and write o once.
//
// bfloat16 (flash_fwd_wgmma_kernel<D>, D = 64, 128, 160): on the tensor
// cores, in the shape of FlashAttention-3. A work item is 128 query rows of
// one (batch, q head); the grid is persistent (one block per SM walks the
// items, the longest causal tiles first). A block has three warpgroups. The
// producer (registers given up with setmaxnreg) issues every load by TMA:
// Q into two buffers, so the next item's Q arrives under this item's tiles,
// and K/V tiles into a two-stage ring with full and empty mbarriers, K
// released as soon as S is computed and V after P V. Two consumer warpgroups
// own 64 rows each. Per tile, one wgmma group computes S = Q K^T (both
// operands in shared memory) and another O += P V of the previous tile (P
// from registers, V read MN-major, one instruction of N = D per 16 keys);
// the softmax of S runs while P V is still on the tensor cores, and named
// barriers make the two warpgroups take turns issuing, so one's softmax also
// runs under the other's products. Scale, softcap and mask act on the fp32
// accumulator registers; each row lies in one quad of threads (2 shuffles
// per reduction). P is rounded into a hi/lo pair of bf16, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), and both products are summed: one bf16 P breaks the
// one-ulp output limit in the early, peaky rows, the pair keeps P to about
// 2^-16; l sums the unrounded P. That is 6*D tensor-core flops per pair
// against the bound's 4*D. Keys past T arrive as TMA's zero fill and are
// masked like any other; the output tile is staged in shared memory and
// stored by TMA, which writes rows < S only. The tensor maps are encoded per
// call from the strides, through the driver entry point that
// cudaGetDriverEntryPoint returns (no -lcuda at link time).
//
// Tiling per head dim (struct Tiling). D 64 and 128: K/V tiles of 128 keys;
// a tile is D/64 boxes of 64 columns, 128-B rows in TMA's 128-B swizzle. On
// the H100 what limits them is the CUDA-core work per tile (the softmax, the
// P split and the exp2s on the MUFU pipe), not the tensor cores or the loads.
//
// D = 160 (stablelm-12b). Shared memory: with 128-key tiles two Q stages,
// two K/V stages and the O tile would take 286,720 B, over a block's
// 232,448. So K/V tiles hold 64 keys: Q 2 x 128 x 160 x 2 = 81,920 B, K and V
// 2 x 64 x 160 x 2 = 40,960 B each, O 40,960 B; 204,800 B before the
// barriers and the 1,024-B alignment. Registers per consumer thread: O 80,
// S 32, P hi/lo 32, about 144 of setmaxnreg's 232 (with 128-key tiles S and
// P would take 64 each, 208 before addressing). Swizzle: 160 is no multiple
// of the 128-B swizzle's 64 columns, so a tile is five boxes of 32 columns,
// 64-B rows in the 64-B swizzle, with one tensor map per operand and
// descriptors of layout type 2: S is 10 k-steps of m64n64k16 (two per box),
// P V one m64n160k16 per 16 keys across the five boxes. This was chosen over
// two 128-B boxes plus one 64-B box of 32 columns (128 + 32), which needs a
// second tensor map per operand, two descriptor kinds in S and two
// instructions in P V; the uniform layout keeps every loop of the D 64/128
// kernel as it is. Padding D to 192 would need 245,760 B. ptxas (-v) gives
// each D's kernel 168 registers (the launch bound's share before setmaxnreg),
// no spill and no serialised wgmma. At stablelm's prefill shape (B=8,
// S=T=2048, 32 query / 8 KV heads, causal) the bound is 0.3476 ms (4*D flops
// per unmasked pair at 989 TFLOP/s) and the hi/lo design's tensor floor
// 0.5214 ms (6*D). On an H100 80GB HBM3 at 700 W (tools/flash_variants.py)
// it took 0.72-0.84 device ms, SDPA 0.69, and what limits it is the tensor
// cores, not the softmax: without its exp2s it took the same time, without
// the P_lo products 0.60 ms, without P V 0.45. The hi/lo pair's extra 2*D
// flops a pair are what it pays beside SDPA. 128-key tiles in a one-stage
// ring (the same shared memory) took 1.46 ms: ptxas serialised their wgmmas
// for want of registers (C7512).
//
// float32 (flash_fwd_kernel): on the fp32 CUDA cores, because fp32 inputs
// come from the full-width fp32 oracle and hold a 2e-4 limit that TF32 or
// bf16 products would not. One block per (batch, q head, 64 query rows); a
// row is owned by G neighbouring threads (D/32 at D = 64 and 128, 8 at
// D = 160, so a row's threads are a power of two and never straddle a warp)
// holding interleaved float4 groups of q and the accumulator in registers;
// K and V tiles are staged in shared memory; dot products are reduced with
// warp shuffles; the online softmax takes 16 keys at a time. It is bounded
// by the fp32 FMA rate (67 TFLOP/s).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;     // query rows per block
constexpr int kKSub = 16;   // keys per online-softmax step

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;      // (B, Hq, S) contiguous, or null: no log-sum-exp
  long long b, hq, hkv, s, t;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no softcap
  float scale;
};

// The CUDA-core kernel's tiling at head dim D: G threads per query row, V4
// float4 groups of the row per thread, BK keys per shared-memory tile (two
// fp32 tiles of BK x D stay under the 48-KB static limit: 40 KB at D = 160).
template <int D>
struct Fp32Tiling {
  static_assert(D == 64 || D == 128 || D == 160, "head dim 64, 128 or 160");
  static constexpr int G = D == 160 ? 8 : D / 32;
  static constexpr int V4 = D / (4 * G);
  static constexpr int BK = D == 64 ? 64 : 32;
};

template <int D>
__global__ void __launch_bounds__(kBQ * Fp32Tiling<D>::G)
flash_fwd_kernel(const FlashArgs a) {
  constexpr int G = Fp32Tiling<D>::G;       // threads per query row
  constexpr int BK = Fp32Tiling<D>::BK;     // keys per shared-memory tile
  constexpr int NT = kBQ * G;
  constexpr int V4 = Fp32Tiling<D>::V4;     // float4 groups per thread
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

  const float* qp = static_cast<const float*>(a.q) + bi * a.qsb + hi * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + bi * a.ksb + hk * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + bi * a.vsb + hk * a.vsh;

  // this thread's dims: float4 group (i * G + g) for i in [0, V4)
  float qr[4 * V4], acc[4 * V4];
#pragma unroll
  for (int i = 0; i < V4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = (i * G + g) * 4 + c;
      qr[i * 4 + c] = qvalid ? qp[qpos * a.qss + d] * a.scale : 0.f;
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
        kx = kp[kpos * a.kss + d];
        vx = vp[kpos * a.vss + d];
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
      for (int i = 0; i < 4 * V4; ++i) acc[i] *= alpha;
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
    float* op = static_cast<float*>(a.o) + bi * a.osb + hi * a.osh + qpos * a.oss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < V4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        op[(i * G + g) * 4 + c] = acc[i * 4 + c] / den;
      }
    }
    // q was scaled on load, so m is in units of the scaled scores
    if (a.lse != nullptr && g == 0) a.lse[(bi * a.hq + hi) * a.s + qpos] = m + logf(den);
  }
}

template <int D>
void launch_fp32(const FlashArgs& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((a.s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.hq), static_cast<unsigned>(a.b));
  flash_fwd_kernel<D><<<grid, kBQ * Fp32Tiling<D>::G, 0, st>>>(a);
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (TMA, mbarriers, wgmma)
// ---------------------------------------------------------------------------

constexpr int kRows = 128;     // query rows per work item: two consumer warpgroups of 64
constexpr int kStages = 2;     // K/V ring depth
constexpr int kQStages = 2;    // Q tiles: the next item's Q loads under this item's tiles
constexpr int kWgThreads = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

struct WgmmaArgs {
  float* lse;        // (B, Hq, S) contiguous, or null: no log-sum-exp
  int s, t, b, hq, hkv, n_qt, n_items;
  int causal;
  int window;        // <= 0: no window
  float softcap;     // <= 0: no softcap
  float scale;       // 1/sqrt(D)
};

// The tiling at head dim D. A tile is stored as kBoxes column boxes of
// [rows][kBox] bf16, each row one span of TMA's swizzle: 64 columns in the
// 128-B swizzle at D 64 and 128, 32 columns in the 64-B swizzle at D = 160
// (no multiple of 64). K/V tiles hold 128 keys, or 64 at D = 160, where two
// stages of 128 would not fit beside two Q stages.
template <int D>
struct Tiling {
  static_assert(D == 64 || D == 128 || D == 160, "head dim 64, 128 or 160");
  static constexpr int kKeys = D == 160 ? 64 : 128;     // keys per K/V tile
  static constexpr int kBox = D == 160 ? 32 : 64;       // bf16 columns per box
  static constexpr int kRowBytes = 2 * kBox;            // a box row: the swizzle's span
  static constexpr int kBoxes = D / kBox;
  static constexpr uint64_t kLayout = D == 160 ? 2 : 1;  // wgmma descriptor: 64-B or 128-B swizzle
};

// Every box is a multiple of 512 B (the 64-B swizzle's period) and the
// 128-B-swizzled ones of 1024 B (its period), from a 1024-B aligned base.
template <int D>
struct alignas(1024) WgmmaSmem {
  using T = Tiling<D>;
  __nv_bfloat16 q[kQStages][T::kBoxes][kRows * T::kBox];
  __nv_bfloat16 k[kStages][T::kBoxes][T::kKeys * T::kBox];
  __nv_bfloat16 v[kStages][T::kBoxes][T::kKeys * T::kBox];
  __nv_bfloat16 o[T::kBoxes][kRows * T::kBox];   // the output tile, staged for its TMA store
  uint64_t q_full[kQStages];
  uint64_t q_empty[kQStages];
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];   // K is released after S, V only after P V
  uint64_t v_empty[kStages];
};
static_assert(sizeof(WgmmaSmem<128>) + 1024 <= kMaxSmem, "shared memory of the D = 128 kernel");
static_assert(sizeof(WgmmaSmem<160>) + 1024 <= kMaxSmem, "shared memory of the D = 160 kernel");

// Work item w -> (query tile, q head, batch). Items are ordered by query tile,
// the longest first in the causal case, so the short ones fill the last wave;
// within a tile rank the q heads of one KV head are neighbours.
struct Item {
  int qt, hi, bi;
};
__device__ __forceinline__ Item item_of(int w, const WgmmaArgs& a) {
  const int per = a.hq * a.b;
  const int rank = w / per, hb = w % per;
  return Item{a.causal ? a.n_qt - 1 - rank : rank, hb % a.hq, hb / a.hq};
}

// The KV tiles of kKeys keys of query rows [q0, q0 + kRows): none past the
// causal frontier or wholly before the window.
template <int kKeys>
__device__ __forceinline__ void kv_range(int q0, const WgmmaArgs& a, int& k_begin, int& n_tiles) {
  const int q_last = (q0 + kRows < a.s ? q0 + kRows : a.s) - 1;
  int k_end = a.t;
  if (a.causal && q_last + 1 < k_end) k_end = q_last + 1;
  k_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) k_begin = q0 - a.window + 1;
  k_begin = (k_begin / kKeys) * kKeys;
  n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arrive where pred holds, without a branch (a branch between a wgmma and its
// wait makes ptxas serialize the wgmmas).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_addr(bar)), "r"(static_cast<int>(pred)) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// One TMA box (64 x rows x 1 x 1) at coordinates (c0, c1, c2, c3) into shared
// memory; completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA box from shared memory to (c0, c1, c2, c3); positions past the
// tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, each in 16-B units, and the layout type (1: 128-B swizzle, 2: 64-B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (layout << 62);
}

// Byte offset of 16-B chunk `chunk` of row `row` in a box of kRowBytes-wide
// rows as TMA's swizzle of that span lays it out: the chunk index XOR bits
// 7.. of the row's offset (128-B swizzle: row % 8; 64-B: (row / 2) % 4).
template <int kRowBytes>
__device__ __forceinline__ int swizzled(int row, int chunk) {
  const int base = row * kRowBytes;
  return base + ((chunk ^ ((base >> 7) & (kRowBytes / 16 - 1))) * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from touching registers that an asynchronous wgmma still
// reads or writes: every use after the wait depends on this barrier.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(r[i][c]) :: "memory");
  }
}

// Named barriers 1 and 2 between the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive_if(int id, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n"
      :: "r"(id), "r"(static_cast<int>(pred)) : "memory");
}
// A named barrier of one warpgroup (128 threads).
__device__ __forceinline__ void named_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (64 x 128, fp32) (+)= A (64 x 16) * B (16 x 128); A and B in shared memory, both
// K-major (no transpose); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 16) * B (16 x 64); A and B in shared memory, both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S = Q K^T for a tile of N keys.
template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// D (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 64);
// B in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 128);
// B in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 160, fp32) += A (64 x 16, bf16 fragments in registers) * B (16 x 160);
// B in shared memory, MN-major (transposed): five 32-column boxes.
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V for one 16-key step: N = D, one instruction over all of V's boxes.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n160(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, const WgmmaArgs a) {
  using T = Tiling<D>;
  constexpr int kKeys = T::kKeys, kBox = T::kBox, kRowBytes = T::kRowBytes, kBoxes = T::kBoxes;
  constexpr int kSteps = kBox / 16;       // 16-dim steps of S within one box
  constexpr int kGroups = kKeys / 8;      // groups of 4 S accumulators: 8 key columns each
  static_assert(kGroups == 8 || kGroups == 16, "the softmax's trees take 8 or 16 groups");
  constexpr uint32_t kTileBytes = kKeys * D * 2;
  extern __shared__ unsigned char smem_raw[];
  WgmmaSmem<D>& sm = *reinterpret_cast<WgmmaSmem<D>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;
  // 0: producer; 1, 2: consumers; read from lane 0 so the compiler knows it
  // is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);

  if (tid == 0) {
    for (int i = 0; i < kQStages; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], 2);         // one arrival per consumer warpgroup
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 2);
      mbar_init(&sm.v_empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The grid is persistent: block j takes work items j, j + gridDim.x, ...
  if (wg == 0) {
    // producer: one thread issues every TMA load, running ahead of the
    // consumers by the depth of the Q and K/V rings
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == 0) {
      int n = 0, kv = 0;
      for (int w = blockIdx.x; w < a.n_items; w += gridDim.x, ++n) {
        const Item it = item_of(w, a);
        const int q0 = it.qt * kRows;
        const int hk = it.hi * a.hkv / a.hq;
        int k_begin, n_tiles;
        kv_range<kKeys>(q0, a, k_begin, n_tiles);
        const int qs = n % kQStages;
        if (n >= kQStages) mbar_wait(&sm.q_empty[qs], ((n / kQStages) & 1) ^ 1);
        mbar_expect_tx(&sm.q_full[qs], kRows * D * 2);
        for (int h = 0; h < kBoxes; ++h)
          tma_load(sm.q[qs][h], &tq, &sm.q_full[qs], h * kBox, q0, it.hi, it.bi);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int st = kv % kStages;
          const uint32_t ep = ((kv / kStages) & 1) ^ 1;
          if (kv >= kStages) mbar_wait(&sm.k_empty[st], ep);
          const int kt = k_begin + i * kKeys;
          mbar_expect_tx(&sm.k_full[st], kTileBytes);
          for (int h = 0; h < kBoxes; ++h)
            tma_load(sm.k[st][h], &tk, &sm.k_full[st], h * kBox, kt, hk, it.bi);
          if (kv >= kStages) mbar_wait(&sm.v_empty[st], ep);
          mbar_expect_tx(&sm.v_full[st], kTileBytes);
          for (int h = 0; h < kBoxes; ++h)
            tma_load(sm.v[st][h], &tv, &sm.v_full[st], h * kBox, kt, hk, it.bi);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each work item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = tid % kWgThreads;
  const int lane = t % 32;
  // this thread's two rows of the item (wgmma accumulator layout) and its
  // first column in every group of 8
  const int r0 = 64 * c + 16 * (t / 32) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale2 = a.scale * kLog2e;
  const float cap_over_scale = a.softcap / a.scale, scale_over_cap = a.scale / a.softcap;

  int n = 0, kv = 0;
  for (int w = blockIdx.x; w < a.n_items; w += gridDim.x, ++n) {
    const Item it = item_of(w, a);
    const int q0 = it.qt * kRows;
    const int qa = q0 + 64 * c;                         // the warpgroup's first row
    int k_begin, n_tiles;
    kv_range<kKeys>(q0, a, k_begin, n_tiles);
    const int qs = n % kQStages;

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    uint32_t p_hi[kKeys / 16][4], p_lo[kKeys / 16][4];   // P of the tile whose P V is pending
    const uint32_t q_base = smem_addr(sm.q[qs][0]) + 64 * c * kRowBytes;
    mbar_wait(&sm.q_full[qs], (n / kQStages) & 1);
    mbar_arrive_if(&sm.q_empty[qs], n_tiles == 0 && t == 0);

    auto wait_k = [&](int j) {
      mbar_wait(&sm.k_full[(kv + j) % kStages], ((kv + j) / kStages) & 1);
    };
    auto wait_v = [&](int j) {
      mbar_wait(&sm.v_full[(kv + j) % kStages], ((kv + j) / kStages) & 1);
    };
    // S = Q K^T for tile j: D/16 steps of 16 dims (32 B of a box row), both
    // operands K-major in shared memory, 8 rows a swizzle atom; committed as
    // one wgmma group
    auto issue_s = [&](float (&sacc)[kKeys / 2], int j) {
      const int st = (kv + j) % kStages;
      const uint32_t k_base = smem_addr(sm.k[st][0]);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / kSteps) * kKeys * kRowBytes + (kk % kSteps) * 32;
        const uint32_t qoff = (kk / kSteps) * kRows * kRowBytes + (kk % kSteps) * 32;
        wgmma_s<kKeys>(sacc, smem_desc(q_base + qoff, 16, 8 * kRowBytes, T::kLayout),
                       smem_desc(k_base + off, 16, 8 * kRowBytes, T::kLayout), kk > 0);
      }
      wgmma_commit();
    };
    // O += P_hi V + P_lo V for tile j: 16 keys per step, V MN-major (the
    // leading offset steps from box to box, the stride from 8 keys to 8)
    auto issue_pv = [&](int j) {
      const int st = (kv + j) % kStages;
      const uint32_t v_base = smem_addr(sm.v[st][0]);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_pv<D>(o, p_hi[kk], smem_desc(v_base + kk * 16 * kRowBytes, kKeys * kRowBytes,
                                           8 * kRowBytes, T::kLayout));
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_pv<D>(o, p_lo[kk], smem_desc(v_base + kk * 16 * kRowBytes, kKeys * kRowBytes,
                                           8 * kRowBytes, T::kLayout));
      wgmma_commit();
    };
    // The online softmax of tile j in the log2 domain: scale, softcap and
    // mask the scores, update the row max and the row sums, and leave
    // exp2(s - max) in sacc; returns the factors that rescale O. Each row
    // lies in one quad of threads.
    auto softmax = [&](float (&sacc)[kKeys / 2], int j, float& alpha0, float& alpha1) {
      const int kt = k_begin + j * kKeys;
      if (a.softcap > 0.f) {
        // cap * tanh(s * scale / cap), kept in units of s
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          sacc[e] = cap_over_scale * tanhf(sacc[e] * scale_over_cap);
        }
      }
      if (kt + kKeys > a.t || (a.causal && qa < kt + kKeys - 1) ||
          (a.window > 0 && qa + 63 - kt >= a.window)) {
        // q_pos - k_pos of element 0 and the keys left before T, relative to
        // this thread's first column; each element adds a constant offset
        const int dq = q0 + r0 - kt - col0;
        const int left = a.t - kt - col0;
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) {
          const int ko = 8 * (e / 4) + (e % 2);
          const int diff = dq + ((e % 4) < 2 ? 0 : 8) - ko;
          bool ok = ko < left;
          if (a.causal) ok = ok && diff >= 0;
          if (a.window > 0) ok = ok && diff < a.window;
          if (!ok) sacc[e] = kNegInf;
        }
      }
      // row maxima as trees of 8 partial maxima (the running max included)
      float mp[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          mp[h][g] = fmaxf(sacc[4 * g + 2 * h], sacc[4 * g + 2 * h + 1]);
          if constexpr (kGroups == 16)
            mp[h][g] = fmaxf(mp[h][g], fmaxf(sacc[32 + 4 * g + 2 * h], sacc[32 + 4 * g + 2 * h + 1]));
        }
#pragma unroll
        for (int w = 4; w >= 1; w /= 2) {
#pragma unroll
          for (int g = 0; g < w; ++g) mp[h][g] = fmaxf(mp[h][g], mp[h][g + w]);
        }
      }
      float mx0 = fmaxf(m0, mp[0][0]), mx1 = fmaxf(m1, mp[1][0]);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // exp(scale * (s - max)) as exp2(s * c - max * c), c = scale * log2(e).
      // A row whose max is still -1e30 has only masked scores so far: c = 0
      // gives each of them exp(0) = 1, as exp(-1e30 - (-1e30)) in the
      // reference, and the first real key clears them through alpha.
      alpha0 = ex2((m0 - mx0) * scale2);
      alpha1 = ex2((m1 - mx1) * scale2);
      m0 = mx0;
      m1 = mx1;
      const float c0 = mx0 == kNegInf ? 0.f : scale2, c1 = mx1 == kNegInf ? 0.f : scale2;
      const float b0 = -mx0 * c0, b1 = -mx1 * c1;
      float sp[2][8];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int e = 4 * g;
        sacc[e] = ex2(fmaf(sacc[e], c0, b0));
        sacc[e + 1] = ex2(fmaf(sacc[e + 1], c0, b0));
        sacc[e + 2] = ex2(fmaf(sacc[e + 2], c1, b1));
        sacc[e + 3] = ex2(fmaf(sacc[e + 3], c1, b1));
        if (g < 8) {
          sp[0][g] = sacc[e] + sacc[e + 1];
          sp[1][g] = sacc[e + 2] + sacc[e + 3];
        } else {
          sp[0][g - 8] += sacc[e] + sacc[e + 1];
          sp[1][g - 8] += sacc[e + 2] + sacc[e + 3];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int w = 4; w >= 1; w /= 2) {
#pragma unroll
          for (int g = 0; g < w; ++g) sp[h][g] += sp[h][g + w];
        }
      }
      l0 = l0 * alpha0 + sp[0][0];      // per-thread partial sums, reduced at the end
      l1 = l1 * alpha1 + sp[1][0];
    };
    // Rescale O, then round P into the hi/lo pair of bf16 A fragments: the
    // accumulator layout of 16 columns is the A-fragment layout of one
    // 16-deep step.
    auto rescale_and_split = [&](const float (&sacc)[kKeys / 2], float alpha0, float alpha1) {
#pragma unroll
      for (int e = 0; e < D / 2; e += 4) {
        o[e] *= alpha0;
        o[e + 1] *= alpha0;
        o[e + 2] *= alpha1;
        o[e + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sacc[8 * kk + 2 * r], x1 = sacc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(h);
          p_hi[kk][r] = bf16x2_bits(h);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
        }
      }
    };

    // Tile j > 0 is one GEMM phase that issues S(j) and O += P(j-1) V(j-1)
    // together; the softmax of S(j) then runs while P V is on the tensor
    // cores. The phases of the two warpgroups alternate (ping-pong on named
    // barriers 1 and 2, warpgroup 0 first), so one's softmax also runs under
    // the other's products.
    if (n_tiles > 0) {
      named_arrive_if(1, c == 1);
      float s[kKeys / 2];
      float alpha0, alpha1;
      named_sync(1 + c);
      wait_k(0);
      wgmma_fence();
      issue_s(s, 0);
      named_arrive_if(2 - c, c == 0 || n_tiles > 1);     // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive_if(&sm.k_empty[kv % kStages], t == 0);
      mbar_arrive_if(&sm.q_empty[qs], n_tiles == 1 && t == 0);   // Q read for the last time
      softmax(s, 0, alpha0, alpha1);
      rescale_and_split(s, alpha0, alpha1);
      for (int j = 1; j < n_tiles; ++j) {
        named_sync(1 + c);
        wait_k(j);
        wait_v(j - 1);
        fence_regs(o);
        wgmma_fence();
        issue_s(s, j);
        issue_pv(j - 1);
        named_arrive_if(2 - c, c == 0 || j + 1 < n_tiles);
        wgmma_wait<1>();                                     // S(j) is ready
        fence_regs(s);
        mbar_arrive_if(&sm.k_empty[(kv + j) % kStages], t == 0);
        mbar_arrive_if(&sm.q_empty[qs], j + 1 == n_tiles && t == 0);
        softmax(s, j, alpha0, alpha1);
        wgmma_wait<0>();                                     // P V of tile j - 1 is done
        fence_regs(o);
        fence_regs(p_hi);
        fence_regs(p_lo);
        mbar_arrive_if(&sm.v_empty[(kv + j - 1) % kStages], t == 0);
        rescale_and_split(s, alpha0, alpha1);
      }
      // O += P V for the last tile
      wait_v(n_tiles - 1);
      fence_regs(o);
      wgmma_fence();
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive_if(&sm.v_empty[(kv + n_tiles - 1) % kStages], t == 0);
    }
    kv += n_tiles;

    // epilogue: o / max(l, 1e-30) in bf16, staged in the boxes' swizzle and
    // stored by TMA, which writes rows < S only
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && lane % 4 == 0) {
      // m is in units of the unscaled scores and l sums exp(scale (s - m)):
      // the natural log-sum-exp of the scaled row is scale * m + log(l)
      float* lp = a.lse + (static_cast<long long>(it.bi) * a.hq + it.hi) * a.s;
      if (q0 + r0 < a.s) lp[q0 + r0] = m0 * a.scale + logf(fmaxf(l0, 1e-30f));
      if (q0 + r0 + 8 < a.s) lp[q0 + r0 + 8] = m1 * a.scale + logf(fmaxf(l1, 1e-30f));
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync_wg(3 + c);                 // the previous item's store has read the stage
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {          // 8 columns: one 16-B chunk of a box row
      constexpr int kChunks = kRowBytes / 16;
      unsigned char* box = reinterpret_cast<unsigned char*>(sm.o[j / kChunks]) + 2 * col0;
      *reinterpret_cast<__nv_bfloat162*>(box + swizzled<kRowBytes>(r0, j % kChunks)) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(box + swizzled<kRowBytes>(r0 + 8, j % kChunks)) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to the TMA unit
    named_sync_wg(3 + c);
    if (t == 0) {
      for (int h = 0; h < kBoxes; ++h)
        tma_store(&to, sm.o[h] + 64 * c * kBox, h * kBox, qa, it.hi, it.bi);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, positions, heads, batch) of bf16 with the given element
// strides, read in boxes of Tiling<D>::kBox x rows in the swizzle of that span;
// out-of-range positions read as zeros. A dimension of size 1 never moves, so
// its stride is replaced by a valid one.
template <int D>
bool encode_map(CUtensorMap* map, const void* base, long long n, long long h,
                long long b, long long sn, long long sh, long long sb, int rows) {
  const long long d = D;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const long long packed = 2 * d * n * h;
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(n > 1 ? 2 * sn : 2 * d),
      static_cast<cuuint64_t>(h > 1 ? 2 * sh : 2 * d * n),
      static_cast<cuuint64_t>(b > 1 ? 2 * sb : packed)};
  const cuuint32_t box[4] = {Tiling<D>::kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      Tiling<D>::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per device: allow the kernel its dynamic shared memory and read the
// SM count, which sizes the persistent grid.
template <int D>
cudaError_t prepare(int smem, int* sms) {
  static int sms_of[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && sms_of[dev] > 0) {
    *sms = sms_of[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) sms_of[dev] = *sms;
  return e;
}

template <int D>
int launch_bf16(const FlashArgs& f, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  constexpr int kKeys = Tiling<D>::kKeys;
  if (!encode_map<D>(&tq, f.q, f.s, f.hq, f.b, f.qss, f.qsh, f.qsb, kRows) ||
      !encode_map<D>(&to, f.o, f.s, f.hq, f.b, f.oss, f.osh, f.osb, kRows / 2) ||
      !encode_map<D>(&tk, f.k, f.t, f.hkv, f.b, f.kss, f.ksh, f.ksb, kKeys) ||
      !encode_map<D>(&tv, f.v, f.t, f.hkv, f.b, f.vss, f.vsh, f.vsb, kKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_qt = (f.s + kRows - 1) / kRows;
  const long long n_items = n_qt * f.hq * f.b;
  if (f.s > (1LL << 30) || f.t > (1LL << 30) || n_items > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgmmaArgs a;
  a.lse = f.lse;
  a.s = static_cast<int>(f.s); a.t = static_cast<int>(f.t); a.b = static_cast<int>(f.b);
  a.hq = static_cast<int>(f.hq); a.hkv = static_cast<int>(f.hkv);
  a.n_qt = static_cast<int>(n_qt); a.n_items = static_cast<int>(n_items);
  a.causal = f.causal; a.window = f.window; a.softcap = f.softcap; a.scale = f.scale;
  const int smem = static_cast<int>(sizeof(WgmmaSmem<D>)) + 1024;
  int sms = 1;
  const cudaError_t e = prepare<D>(smem, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_fwd_wgmma_kernel<D><<<grid, 3 * kWgThreads, smem, st>>>(tq, tk, tv, to, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// meta: b, hq, hkv, s, t, then the (batch, head, position) strides in
// elements of q, k, v and o. lse: null, or a contiguous float32 (B, Hq, S)
// that receives each row's natural-log log-sum-exp of its scaled, softcapped
// and masked scores (the softmax statistics a backward recomputes P from).
// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the wgmma kernel);
// head dims 64, 128 and 160 in both. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another head dim, an unknown dtype, or bf16
// tensors whose TMA maps cannot be encoded (base pointers must be 16-B
// aligned, strides multiples of 16 B).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, float* lse, const long long* meta, int dtype,
                                     int head_dim, int causal, int window,
                                     float softcap, float scale, int device,
                                     void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.b = meta[0]; a.hq = meta[1]; a.hkv = meta[2]; a.s = meta[3]; a.t = meta[4];
  a.qsb = meta[5]; a.qsh = meta[6]; a.qss = meta[7];
  a.ksb = meta[8]; a.ksh = meta[9]; a.kss = meta[10];
  a.vsb = meta[11]; a.vsh = meta[12]; a.vss = meta[13];
  a.osb = meta[14]; a.osh = meta[15]; a.oss = meta[16];
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  if (a.b <= 0 || a.hq <= 0 || a.s <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) launch_fp32<64>(a, st);
  else if (dtype == 0 && head_dim == 128) launch_fp32<128>(a, st);
  else if (dtype == 0 && head_dim == 160) launch_fp32<160>(a, st);
  else if (dtype == 1 && head_dim == 64) return launch_bf16<64>(a, st);
  else if (dtype == 1 && head_dim == 128) return launch_bf16<128>(a, st);
  else if (dtype == 1 && head_dim == 160) return launch_bf16<160>(a, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

