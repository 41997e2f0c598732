// Causal, segment-masked flash attention, forward and backward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU flash-attention kernel that
// areal_tpu/ops/flash_attention.py:36 `flash_attention` calls (jax's
// `pallas.ops.tpu.flash_attention`: forward, `dkv` and `dq` backward
// kernels).  Same contract: over packed rows `[B, T]`, query i attends key
// j iff seg[i] == seg[j] != 0 and j <= i (causal by index within the row),
// with scale 1/sqrt(hd); the forward saves only the logsumexp for the
// backward.  A padding query (seg 0) gets output 0, lse = +inf, and zero
// gradients.  GQA: query head h reads KV head h / (Hq / Hkv) in the
// kernel; KV is never repeated.
//
// Layouts (all contiguous): q, out, dout, dq [B, T, Hq, hd]; k, v, dk, dv
// [B, T, Hkv, hd]; seg [B, T] int32; lse and D [B, Hq, T] float32;
// ranges [B, ceil(T / 32), 2] int32 (min nonzero and max segment id of
// each 32-token tile); the backward's f32 workspaces dk_ws, dv_ws
// [B, T, Hq, hd].
//
// Arithmetic: bf16 tensor-core products with f32 accumulation (warpgroup
// `wgmma`), as the TPU kernel's bf16-operand / f32-accumulate dots; the
// online softmax, lse and D are f32.  The probabilities P and dS are
// rounded to bf16 before their products with V, dO, K and Q, as on the
// TPU; dq, dk and dv accumulate in f32.
//
// What bounds it on an H100: operations.  The forward does 4 * Hq * hd
// flops per attended (i, j) pair (QK^T and PV), the backward 10 (QK^T
// recomputed, dO V^T, P^T dO, dS^T Q, dS K; the dq and dk/dv kernels
// recompute QK^T and dO V^T each, 14 in all); at a 4096-token row that is
// ~900 flops per byte of q/k/v, far right of the card's ~295 flop/byte
// ridge.  What the design does about it, in every kernel:
// * Tensor cores for every product, on Hopper's warpgroup `wgmma`: a
//   block is one warpgroup owning a 64-row tile; S (and dP) are
//   m64n64k16 products with both operands read from shared memory through
//   matrix descriptors, and the products with P or dS take them from
//   registers (the accumulator converted to bf16 A fragments) and read the
//   other operand from the same tile MN-major.  Tiles are stored in the
//   128-byte swizzle layout, so no fragment passes through registers on
//   its way from shared memory and no read conflicts on a bank.
// * Tiles that lie wholly above the diagonal or outside every segment of
//   the other side's tile are skipped (a per-32-token-tile [min, max]
//   segment-id table, built by a small kernel, decides) and issue no
//   copy, so a packed row costs ~sum L_s^2 instead of T^2.
// * Copies overlap products: the streamed tiles go through a two-stage
//   `cp.async` ring written straight into the swizzled tiles; tile i + 1
//   loads while tile i multiplies, one barrier per tile.  A block takes
//   ~84-100 KB of shared memory, so two share an SM.
// * exp2 of log2-domain scores on the special-function unit
//   (`ex2.approx`), one instruction per probability.
// The forward: one block per (query tile of 64, query head, row); the Q
// tile stays in shared memory while K, V and the keys' segment ids stream
// through the ring; the grid is flattened so that the query tiles with
// the most keys start first across every head and row.  A key tile below
// the diagonal whose queries and keys all share one segment (checked in
// the barrier that ends each copy wait) skips the per-element mask.  A
// 128-key tile (one 64 x 128 S product per k-step, one block per SM) and
// two warpgroups per block sharing a three-stage ring both measured
// slower.
// The backward:
// * Enough independent blocks, no serial chain.  A dk/dv block owns (key
//   tile of 64, QUERY head, row), not (key tile, KV head, row), so the
//   grid has Hq / Hkv = 6x more blocks (1536 at B=2, T=4096) and no block
//   loops over its group's heads; it writes its head's f32 partials to a
//   workspace and a small kernel sums each group's r partials in a fixed
//   order, so GQA needs no atomics and the gradients stay bit-for-bit
//   repeatable.  The dq and dk/dv grids are flattened as the forward's.
// * Q/dO/lse/D tiles (dk/dv) and K/V tiles (dq) stream through the ring.
// Still to do (later work): TMA loads from a producer warp, and
// overlapping the next tile's products with this tile's elementwise work
// (a deeper ring needs the shared memory two blocks per SM now share).
//
// Plain C interface, bound from Python with ctypes
// (areal_tpu_torch/ops/flash_attention.py); no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kRangeTile = 32;  // granularity of the segment-range table
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// [min nonzero segment id, max segment id] of the tiles [t0, t0 + n) of
// the range table, merged; min > max when the tiles hold no real token.
__device__ __forceinline__ int2 tile_range(const int* ranges, int n_rt,
                                           int t0, int n) {
  int lo = 0x7fffffff, hi = 0;
  for (int t = t0; t < t0 + n && t < n_rt; ++t) {
    lo = min(lo, ranges[2 * t]);
    hi = max(hi, ranges[2 * t + 1]);
  }
  return make_int2(lo, hi);
}

__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return a.y > 0 && b.y > 0 && a.x <= b.y && b.x <= a.y;
}

// ---- segment-range table ---------------------------------------------------

__global__ void seg_ranges_kernel(const int* __restrict__ seg,
                                  int* __restrict__ ranges, int B, int T,
                                  int n_rt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * n_rt) return;
  const int b = i / n_rt, t0 = (i % n_rt) * kRangeTile;
  int lo = 0x7fffffff, hi = 0;
  for (int t = t0; t < min(T, t0 + kRangeTile); ++t) {
    const int s = seg[(long long)b * T + t];
    if (s != 0) lo = min(lo, s);
    hi = max(hi, s);
  }
  ranges[2 * i] = lo;
  ranges[2 * i + 1] = hi;
}

// ---- copies and fragments shared by the forward and backward ---------------

// Copy 64 rows of HD bf16 (global row i at base + i * gstride) with
// cp.async into a 64-row tile in the 128-byte swizzle layout wgmma reads
// (tc::swz_offset); rows at or past `valid` are zero-filled and not read.
template <int HD>
__device__ __forceinline__ void copy_tile(unsigned char* s, const bf16* base,
                                          long long gstride, int valid) {
  constexpr int kVec = HD / 8;                  // 16-byte pieces per row
  constexpr int kRows = kThreads / kVec;     // rows per pass
  static_assert(kRows % 8 == 0, "passes keep a row's swizzle phase");
  const int i0 = threadIdx.x / kVec, c = (threadIdx.x % kVec) * 8;
  // a thread's rows are i0 + kRows p: one swizzle phase, fixed strides
  unsigned char* dst = s + tc::swz_offset(64, i0, c);
  const bf16* src = base + i0 * gstride + c;
#pragma unroll
  for (int p = 0; p < 64 / kRows; ++p) {
    const bool in = i0 + p * kRows < valid;
    tc::cp_async16(dst + p * kRows * 128, in ? src + p * kRows * gstride : base,
                   in);
  }
}

// Copy n (<= kThreads) 4-byte values src[0..n) into shared memory with
// cp.async; those at or past `valid` are zero-filled.
__device__ __forceinline__ void copy_words(void* s, const void* src, int n,
                                           int valid) {
  const int i = threadIdx.x;
  if (i < n) {
    const bool in = i < valid;
    tc::cp_async4(static_cast<uint32_t*>(s) + i,
                  static_cast<const uint32_t*>(src) + (in ? i : 0), in);
  }
}

constexpr int round1k(int n) { return (n + 1023) / 1024 * 1024; }

// The A fragments (bf16) of the four 16-column steps of a 64 x 64
// accumulator held as s[4j + x] (row g + 8 (x >> 1), column 8j + 2tq +
// (x & 1)).
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[4][4],
                                             const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kc][x] = tc::pack_bf16(s[8 * kc + 2 * x], s[8 * kc + 2 * x + 1]);
}

// acc[64 x HD] += A [64 x 64] (registers, four 16-column steps) times the
// 64-row tile b read MN-major (its rows are the product's k).
template <int HD>
__device__ __forceinline__ void issue_rows_product(float (&acc)[HD / 2],
                                                   const uint32_t (&a)[4][4],
                                                   const unsigned char* b) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    tc::wgmma_rs<HD>(acc, a[kc], tc::wg_desc(b + kc * 16 * 128, 64 * 128, 1024));
}

// ---- forward ----------------------------------------------------------------

constexpr int kFwdStages = 2;  // depth of the forward's K/V copy ring

// Shared-memory plan of the forward (byte offsets from a 1024-aligned
// base): the Q tile and its segment ids, then a ring of 64-key stages (K,
// V and the keys' segment ids).  About 84 KB at hd 128: two blocks share
// an SM.
template <int HD>
struct FwdSmem {
  static constexpr int kTile = 64 * HD * 2;  // a 64-row bf16 tile
  static constexpr int kQ = 0, kSegQ = kTile;
  static constexpr int kRing = round1k(kSegQ + 64 * 4);
  static constexpr int kStage = round1k(2 * kTile + 64 * 4);
  static constexpr int kBytes = kRing + kFwdStages * kStage + 1024;
};

// One block (a warpgroup) per (query tile of 64, query head h, row b), the
// tiles with the most keys first across every head and row.  It walks the
// 64-key tiles up to the diagonal that share a segment with it, K/V and
// their segment ids streaming through the copy ring; S = Q K^T and O +=
// P V run on wgmma.  Warp w owns query rows 16w..16w+15.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ seg,
              const int* __restrict__ ranges, bf16* __restrict__ out,
              float* __restrict__ lse, int B, int T, int Hq, int Hkv,
              int n_rt, float scale_log2) {
  using L = FwdSmem<HD>;
  constexpr int BM = 64, BN = 64, S = kFwdStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const unsigned char* Qs = smem + L::kQ;
  const int* segq = reinterpret_cast<const int*>(smem + L::kSegQ);
  unsigned char* ring = smem + L::kRing;

  const int n_qt = (T + BM - 1) / BM;
  const int per = Hq * B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = blockIdx.x % per % Hq, b = blockIdx.x % per / Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * BM;
  const int* rng = ranges + (long long)b * n_rt * 2;
  const int2 qr = tile_range(rng, n_rt, q0 / kRangeTile, BM / kRangeTile);
  const int kt_last = qt;  // the diagonal tile (k0 = q0 < T)

  const long long qstride = (long long)Hq * HD;
  const long long kstride = (long long)Hkv * HD;
  copy_tile<HD>(smem + L::kQ, q + ((long long)b * T + q0) * qstride + h * HD,
                qstride, T - q0);
  copy_words(smem + L::kSegQ, seg + (long long)b * T + q0, BM, T - q0);

  // the next key tile at or after kt that shares a segment with the query
  // tile (kt_last + 1 when none is left)
  auto next_active = [&](int kt) {
    for (; kt <= kt_last; ++kt)
      if (ranges_meet(qr, tile_range(rng, n_rt, kt * BN / kRangeTile,
                                     BN / kRangeTile)))
        return kt;
    return kt_last + 1;
  };
  auto load_stage = [&](int kt, int slot) {
    unsigned char* st = ring + slot * L::kStage;
    const int k0 = kt * BN;
    const long long koff = ((long long)b * T + k0) * kstride + hk * HD;
    copy_tile<HD>(st, k + koff, kstride, T - k0);
    copy_tile<HD>(st + L::kTile, v + koff, kstride, T - k0);
    copy_words(st + 2 * L::kTile, seg + (long long)b * T + k0, BN, T - k0);
  };

  // online-softmax state of rows g and g + 8 of the warp (log2 domain)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.f;

  // prologue: the query side and the first S - 1 key tiles
  int kt_load = next_active(0);
  for (int st = 0; st < S - 1; ++st) {
    if (kt_load <= kt_last) {
      load_stage(kt_load, st);
      kt_load = next_active(kt_load + 1);
    }
    tc::cp_async_commit();
  }
  for (int kt = next_active(0), i = 0; kt <= kt_last;
       kt = next_active(kt + 1), ++i) {
    const unsigned char* st = ring + (i % S) * L::kStage;
    const unsigned char* Ks = st;
    const unsigned char* Vs = st + L::kTile;
    const int* segk = reinterpret_cast<const int*>(st + 2 * L::kTile);
    const int k0 = kt * BN;
    tc::cp_async_wait<S - 2>();
    tc::fence_proxy_async();
    // tile i landed for all; the stage of tile i-1 is free.  The tile
    // needs no mask when it lies below the diagonal and every query and
    // key of the two tiles is in one segment (each thread checks the ids
    // it copied itself against the query tile's least nonzero id).
    const int tid = threadIdx.x;
    const bool same = (tid >= BM || segq[tid] == qr.x) &&
                      (tid >= BN || segk[tid] == qr.x);
    const bool full = __syncthreads_and(same) && k0 + BN - 1 <= q0;
    if (kt_load <= kt_last) {
      load_stage(kt_load, (i + S - 1) % S);
      kt_load = next_active(kt_load + 1);
    }
    tc::cp_async_commit();

    // S = Q K^T: 64 queries x 64 keys, s[4j + x] holds
    // query 16w + g + 8 (x >> 1), key 8j + 2tq + (x & 1)
    float s[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) s[x] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk >> 2) * 64 * 128 + (kk & 3) * 32;
      tc::wgmma_64x64_ss(s, tc::wg_desc(Qs + off, 16, 1024),
                         tc::wg_desc(Ks + off, 16, 1024));
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_fence_acc(s);

    // mask, online softmax (log2 domain)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = warp * 16 + g + hr * 8;
      float mx = -INFINITY;
      if (full) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + hr * 2 + c;
            s[x] *= scale_log2;
            mx = fmaxf(mx, s[x]);
          }
        }
      } else {
        const int sq = segq[row];
        const int qi = q0 + row;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = j * 8 + tq * 2 + c;
            const int x = 4 * j + hr * 2 + c;
            const bool ok = sq != 0 && segk[col] == sq && k0 + col <= qi;
            s[x] = ok ? s[x] * scale_log2 : -INFINITY;
            mx = fmaxf(mx, s[x]);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -INFINITY) {
        alpha = tc::exp2_approx(m[hr] - m_new);  // 0 when m[hr] is -inf
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + hr * 2 + c;
            s[x] = tc::exp2_approx(s[x] - m_new);  // 0 where masked
            rs += s[x];
          }
        }
      } else {  // nothing attended yet: this row's probabilities are 0
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) s[4 * j + hr * 2] = s[4 * j + hr * 2 + 1] = 0.f;
      }
      m[hr] = m_new;
      l[hr] = l[hr] * alpha + rs;  // this thread's columns; summed at the end
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + hr * 2] *= alpha;
        acc[4 * j + hr * 2 + 1] *= alpha;
      }
    }
    // O += P V: P rounded to bf16 in registers, V read MN-major (its rows
    // are the keys)
    uint32_t a[4][4];
    acc_to_frags(a, s);
    tc::wg_fence();
    issue_rows_product<HD>(acc, a, Vs);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_fence_acc(acc);
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int qi = q0 + warp * 16 + g + hr * 8;
    if (qi >= T) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    bf16* o = out + ((long long)b * T + qi) * qstride + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8 + tq * 2) =
          __floats2bfloat162_rn(acc[4 * j + hr * 2] * inv,
                                acc[4 * j + hr * 2 + 1] * inv);
    }
    if (tq == 0)
      lse[((long long)b * Hq + h) * T + qi] =
          lt > 0.f ? (m[hr] + log2f(lt)) * kLn2 : INFINITY;
  }
}

// ---- backward ---------------------------------------------------------------

constexpr int kBwdStages = 2;  // depth of the copy rings

// D[b, h, t] = sum_d dout * out (f32), one warp per (b, t, h) row.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dot_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                  float* __restrict__ D, int B, int T, int Hq) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * T * Hq) return;
  const bf16* o = out + row * HD;
  const bf16* d = dout + row * HD;
  float acc = 0.f;
  for (int c = lane * 2; c < HD; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 e = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(d + c));
    acc = fmaf(a.x, e.x, fmaf(a.y, e.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const long long bt = row / Hq;
    const int t = static_cast<int>(bt % T);
    const long long b = bt / T;
    D[(b * Hq + h) * T + t] = acc;
  }
}

// The backward's two 64 x 64 products over the head dim, S = A B^T and
// dP = C D^T (all four 64-row K-major tiles in shared memory), issued
// together and waited for.
template <int HD>
__device__ __forceinline__ void scores_pair(float (&s)[32], float (&dp)[32],
                                            const unsigned char* a,
                                            const unsigned char* b,
                                            const unsigned char* c,
                                            const unsigned char* d) {
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk >> 2) * 64 * 128 + (kk & 3) * 32;
    tc::wgmma_64x64_ss(s, tc::wg_desc(a + off, 16, 1024),
                       tc::wg_desc(b + off, 16, 1024));
    tc::wgmma_64x64_ss(dp, tc::wg_desc(c + off, 16, 1024),
                       tc::wg_desc(d + off, 16, 1024));
  }
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::wg_fence_acc(s);
  tc::wg_fence_acc(dp);
}

// Shared-memory plan of the dq kernel (byte offsets from a 1024-aligned
// base): the Q and dO tiles with their segment ids, lse and D, then a
// ring of K/V stages with their segment ids.
template <int HD>
struct DqSmem {
  static constexpr int kTile = 64 * HD * 2;  // a 64-row bf16 tile
  static constexpr int kQ = 0, kDO = kTile, kSegQ = 2 * kTile;
  static constexpr int kLse = kSegQ + 64 * 4, kD = kLse + 64 * 4;
  static constexpr int kRing = round1k(kD + 64 * 4);
  static constexpr int kStage = round1k(2 * kTile + 64 * 4);  // K, V, seg
  static constexpr int kBytes = kRing + kBwdStages * kStage + 1024;
};

// dq: one block (a warpgroup) per (query tile of 64, query head, row), the
// tiles with the most keys first; it walks the key tiles up to the
// diagonal that share a segment with it, K/V streaming through the copy
// ring.  Warp w owns query rows 16w..16w+15 of every product.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const int* __restrict__ ranges, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 bf16* __restrict__ dq, int B, int T, int Hq, int Hkv,
                 int n_rt, float scale, float scale_log2) {
  using L = DqSmem<HD>;
  constexpr int BM = 64, BN = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const unsigned char* Qs = smem + L::kQ;
  const unsigned char* dOs = smem + L::kDO;
  const int* segq = reinterpret_cast<const int*>(smem + L::kSegQ);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
  const float* D_s = reinterpret_cast<const float*>(smem + L::kD);
  unsigned char* ring = smem + L::kRing;

  const int n_qt = (T + BM - 1) / BM;
  const int per = Hq * B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = blockIdx.x % per % Hq, b = blockIdx.x % per / Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * BM;
  const int* rng = ranges + (long long)b * n_rt * 2;
  const int2 qr = tile_range(rng, n_rt, q0 / kRangeTile, BM / kRangeTile);

  const long long qstride = (long long)Hq * HD;
  const long long kstride = (long long)Hkv * HD;
  const long long qoff = ((long long)b * T + q0) * qstride + h * HD;
  const long long loff = ((long long)b * Hq + h) * T + q0;
  copy_tile<HD>(smem + L::kQ, q + qoff, qstride, T - q0);
  copy_tile<HD>(smem + L::kDO, dout + qoff, qstride, T - q0);
  copy_words(smem + L::kSegQ, seg + (long long)b * T + q0, BM, T - q0);
  copy_words(smem + L::kLse, lse + loff, BM, T - q0);
  copy_words(smem + L::kD, D + loff, BM, T - q0);

  // the next key tile at or after kt that shares a segment with the query
  // tile (qt + 1 when none is left)
  auto next_active = [&](int kt) {
    for (; kt <= qt; ++kt)
      if (ranges_meet(qr, tile_range(rng, n_rt, kt * BN / kRangeTile,
                                     BN / kRangeTile)))
        return kt;
    return qt + 1;
  };
  auto load_stage = [&](int kt, int slot) {
    unsigned char* st = ring + slot * L::kStage;
    const int k0 = kt * BN;
    const long long koff = ((long long)b * T + k0) * kstride + hk * HD;
    copy_tile<HD>(st, k + koff, kstride, T - k0);
    copy_tile<HD>(st + L::kTile, v + koff, kstride, T - k0);
    copy_words(st + 2 * L::kTile, seg + (long long)b * T + k0, BN, T - k0);
  };

  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.f;

  // prologue: the query side and the first kBwdStages - 1 key tiles
  int kt_load = next_active(0);
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (kt_load <= qt) {
      load_stage(kt_load, s);
      kt_load = next_active(kt_load + 1);
    }
    tc::cp_async_commit();
  }
  for (int kt = next_active(0), i = 0; kt <= qt; kt = next_active(kt + 1), ++i) {
    tc::cp_async_wait<kBwdStages - 2>();
    tc::fence_proxy_async();
    __syncthreads();  // tile i landed for all; the stage of tile i-1 is free
    if (kt_load <= qt) {
      load_stage(kt_load, (i + kBwdStages - 1) % kBwdStages);
      kt_load = next_active(kt_load + 1);
    }
    tc::cp_async_commit();

    const unsigned char* st = ring + (i % kBwdStages) * L::kStage;
    const unsigned char* Ks = st;
    const unsigned char* Vs = st + L::kTile;
    const int* segk = reinterpret_cast<const int*>(st + 2 * L::kTile);
    const int k0 = kt * BN;

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, s[4j + x] holds
    // query 16w + g + 8 (x >> 1), key 8j + 2tq + (x & 1)
    float s[32], dp[32];
    scores_pair<HD>(s, dp, Qs, Ks, dOs, Vs);
    // dS = P * (dP - D), P = exp(S - lse) on attended pairs, else 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = warp * 16 + g + hr * 8;
      const int sq = segq[row];
      const int qi = q0 + row;
      const float ls = lse_s[row] * kLog2e, d = D_s[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = j * 8 + tq * 2 + c;
          const int x = 4 * j + hr * 2 + c;
          const bool ok = sq != 0 && segk[col] == sq && k0 + col <= qi;
          const float p = ok ? tc::exp2_approx(s[x] * scale_log2 - ls) : 0.f;
          s[x] = p * (dp[x] - d);
        }
      }
    }
    // dQ += dS K (K read MN-major: its rows are the keys)
    uint32_t a[4][4];
    acc_to_frags(a, s);
    tc::wg_fence();
    issue_rows_product<HD>(acc, a, Ks);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_fence_acc(acc);
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + warp * 16 + g + hr * 8;
    if (qi >= T) continue;
    bf16* o = dq + ((long long)b * T + qi) * qstride + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8 + tq * 2) =
          __floats2bfloat162_rn(acc[4 * j + hr * 2] * scale,
                                acc[4 * j + hr * 2 + 1] * scale);
    }
  }
}

// Shared-memory plan of the dk/dv kernel (byte offsets from a
// 1024-aligned base): the K and V tiles with their segment ids, then a
// ring of query stages (Q, dO, segment ids, lse, D).
template <int HD>
struct DkvSmem {
  static constexpr int kTile = 64 * HD * 2;
  static constexpr int kK = 0, kV = kTile, kSegK = 2 * kTile;
  static constexpr int kRing = round1k(kSegK + 64 * 4);
  static constexpr int kSegQ = 2 * kTile, kLse = kSegQ + 64 * 4,
                       kD = kLse + 64 * 4;
  static constexpr int kStage = round1k(kD + 64 * 4);
  static constexpr int kBytes = kRing + kBwdStages * kStage + 1024;
};

// dk, dv partials of ONE query head: one block (a warpgroup) per (key
// tile of 64, query head h, row), key tile 0 (the most query tiles below
// the diagonal) first.  It walks the query tiles at or below the diagonal
// that share a segment with it, Q/dO/lse/D streaming through the copy
// ring, and writes its head's f32 partials dk_ws, dv_ws [B, T, Hq, hd]
// (dk unscaled); the reduce kernel sums each group's heads.  The products
// hold S^T = K Q^T with keys as rows, so P^T and dS^T feed dV += P^T dO
// and dK += dS^T Q straight from the accumulators.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   const int* __restrict__ ranges,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                   int B, int T, int Hq, int Hkv, int n_rt,
                   float scale_log2) {
  using L = DkvSmem<HD>;
  constexpr int BN = 64, BQ = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const unsigned char* Ks = smem + L::kK;
  const unsigned char* Vs = smem + L::kV;
  const int* segk = reinterpret_cast<const int*>(smem + L::kSegK);
  unsigned char* ring = smem + L::kRing;

  const int per = Hq * B;
  const int kt = static_cast<int>(blockIdx.x) / per;
  const int h = blockIdx.x % per % Hq, b = blockIdx.x % per / Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = kt * BN;
  const int* rng = ranges + (long long)b * n_rt * 2;
  const int2 kr = tile_range(rng, n_rt, k0 / kRangeTile, BN / kRangeTile);
  const int n_qt = (T + BQ - 1) / BQ;

  const long long qstride = (long long)Hq * HD;
  const long long kstride = (long long)Hkv * HD;
  const long long koff = ((long long)b * T + k0) * kstride + hk * HD;
  copy_tile<HD>(smem + L::kK, k + koff, kstride, T - k0);
  copy_tile<HD>(smem + L::kV, v + koff, kstride, T - k0);
  copy_words(smem + L::kSegK, seg + (long long)b * T + k0, BN, T - k0);

  // the next query tile at or after qt that shares a segment with the key
  // tile (n_qt when none is left)
  auto next_active = [&](int qt) {
    for (; qt < n_qt; ++qt)
      if (ranges_meet(kr, tile_range(rng, n_rt, qt * BQ / kRangeTile,
                                     BQ / kRangeTile)))
        return qt;
    return n_qt;
  };
  auto load_stage = [&](int qt, int slot) {
    unsigned char* st = ring + slot * L::kStage;
    const int q0 = qt * BQ;
    const long long qoff = ((long long)b * T + q0) * qstride + h * HD;
    const long long loff = ((long long)b * Hq + h) * T + q0;
    copy_tile<HD>(st, q + qoff, qstride, T - q0);
    copy_tile<HD>(st + L::kTile, dout + qoff, qstride, T - q0);
    copy_words(st + L::kSegQ, seg + (long long)b * T + q0, BQ, T - q0);
    copy_words(st + L::kLse, lse + loff, BQ, T - q0);
    copy_words(st + L::kD, D + loff, BQ, T - q0);
  };

  float dkacc[HD / 2], dvacc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dkacc[x] = dvacc[x] = 0.f;

  // prologue: the key side and the first kBwdStages - 1 query tiles
  // (query tiles at or below the key tile's diagonal start at k0 / BQ)
  int qt_load = next_active(k0 / BQ);
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (qt_load < n_qt) {
      load_stage(qt_load, s);
      qt_load = next_active(qt_load + 1);
    }
    tc::cp_async_commit();
  }
  for (int qt = next_active(k0 / BQ), i = 0; qt < n_qt;
       qt = next_active(qt + 1), ++i) {
    tc::cp_async_wait<kBwdStages - 2>();
    tc::fence_proxy_async();
    __syncthreads();  // tile i landed for all; the stage of tile i-1 is free
    if (qt_load < n_qt) {
      load_stage(qt_load, (i + kBwdStages - 1) % kBwdStages);
      qt_load = next_active(qt_load + 1);
    }
    tc::cp_async_commit();

    const unsigned char* st = ring + (i % kBwdStages) * L::kStage;
    const unsigned char* Qs = st;
    const unsigned char* dOs = st + L::kTile;
    const int* segq = reinterpret_cast<const int*>(st + L::kSegQ);
    const float* lse_s = reinterpret_cast<const float*>(st + L::kLse);
    const float* D_s = reinterpret_cast<const float*>(st + L::kD);
    const int q0 = qt * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, s[4j + x] holds
    // key 16w + g + 8 (x >> 1), query 8j + 2tq + (x & 1)
    float s[32], dp[32];
    scores_pair<HD>(s, dp, Ks, Qs, Vs, dOs);
    // P^T (kept in s) and dS^T (in dp)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = warp * 16 + g + hr * 8;
      const int sk = segk[key];
      const int jk = k0 + key;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = j * 8 + tq * 2 + c;
          const int x = 4 * j + hr * 2 + c;
          const int sq = segq[col];
          const bool ok = sq != 0 && sk == sq && jk <= q0 + col;
          const float p =
              ok ? tc::exp2_approx(s[x] * scale_log2 - lse_s[col] * kLog2e) : 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - D_s[col]);
        }
      }
    }
    // dV += P^T dO ; dK += dS^T Q (dO and Q read MN-major: their rows are
    // the queries)
    uint32_t ap[4][4], ads[4][4];
    acc_to_frags(ap, s);
    tc::wg_fence();
    issue_rows_product<HD>(dvacc, ap, dOs);
    acc_to_frags(ads, dp);
    tc::wg_fence();
    issue_rows_product<HD>(dkacc, ads, Qs);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_fence_acc(dvacc);
    tc::wg_fence_acc(dkacc);
  }
  tc::cp_async_wait<0>();

  // this head's partials; every key row < T is written (zeros when no
  // query tile met the key tile), so the workspace needs no clearing
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int jk = k0 + warp * 16 + g + hr * 8;
    if (jk >= T) continue;
    const long long off = (((long long)b * T + jk) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(dk_ws + off + j * 8 + tq * 2) =
          make_float2(dkacc[4 * j + hr * 2], dkacc[4 * j + hr * 2 + 1]);
      *reinterpret_cast<float2*>(dv_ws + off + j * 8 + tq * 2) =
          make_float2(dvacc[4 * j + hr * 2], dvacc[4 * j + hr * 2 + 1]);
    }
  }
}

// dk[b, t, hk] = scale * sum_j dk_ws[b, t, hk * r + j] and dv likewise, j
// = 0 .. r-1 in that fixed order (no atomics: bit-for-bit repeatable);
// one thread per 4 columns of a (b, t, KV head) row.
template <int HD>
__global__ void __launch_bounds__(256)
fa_bwd_reduce_kernel(const float* __restrict__ dk_ws,
                     const float* __restrict__ dv_ws, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, long long rows, int r,
                     float scale) {
  constexpr int kV4 = HD / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * kV4) return;
  const long long row = idx / kV4;  // (b * T + t) * Hkv + hk
  const int c = static_cast<int>(idx % kV4) * 4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), e = a;
  for (int j = 0; j < r; ++j) {
    // the workspace row of query head hk * r + j
    const long long w = (row * r + j) * HD + c;
    const float4 x = *reinterpret_cast<const float4*>(dk_ws + w);
    const float4 y = *reinterpret_cast<const float4*>(dv_ws + w);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    e.x += y.x; e.y += y.y; e.z += y.z; e.w += y.w;
  }
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + row * HD + c);
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + row * HD + c);
  ok[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
  ok[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
  ov[0] = __floats2bfloat162_rn(e.x, e.y);
  ov[1] = __floats2bfloat162_rn(e.z, e.w);
}

cudaError_t launch_ranges(const int* seg, int* ranges, int B, int T,
                          cudaStream_t st) {
  const int n_rt = (T + kRangeTile - 1) / kRangeTile;
  const int n = B * n_rt;
  seg_ranges_kernel<<<(n + 127) / 128, 128, 0, st>>>(seg, ranges, B, T, n_rt);
  return cudaGetLastError();
}

template <int HD>
cudaError_t fwd_typed(const void* q, const void* k, const void* v,
                      const int* seg, int* ranges, void* out, float* lse,
                      int B, int T, int Hq, int Hkv, cudaStream_t st) {
  cudaError_t err = launch_ranges(seg, ranges, B, T, st);
  if (err != cudaSuccess) return err;
  const int n_rt = (T + kRangeTile - 1) / kRangeTile;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  constexpr int smem = FwdSmem<HD>::kBytes;
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const unsigned n_tiles = static_cast<unsigned>((T + 63) / 64);
  fa_fwd_kernel<HD><<<n_tiles * Hq * B, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, ranges, static_cast<bf16*>(out), lse,
      B, T, Hq, Hkv, n_rt, scale * kLog2e);
  return cudaGetLastError();
}

// the backward's kernels, as bits of flash_attention_bwd's `parts`
constexpr int kPartD = 1, kPartDq = 2, kPartDkdv = 4, kPartReduce = 8;

template <int HD>
cudaError_t bwd_typed(const void* q, const void* k, const void* v,
                      const int* seg, const int* ranges, const void* out,
                      const void* dout, const float* lse, float* D,
                      float* dk_ws, float* dv_ws, void* dq, void* dk,
                      void* dv, int B, int T, int Hq, int Hkv, int parts,
                      cudaStream_t st) {
  const int n_rt = (T + kRangeTile - 1) / kRangeTile;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  cudaError_t err = cudaSuccess;
  if (parts & kPartD) {
    const long long rows = (long long)B * T * Hq;
    const int warps = kThreads / 32;
    fa_bwd_dot_kernel<HD><<<static_cast<unsigned>((rows + warps - 1) / warps),
                            kThreads, 0, st>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), D, B,
        T, Hq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t dq_attr = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem<HD>::kBytes);
  if (dq_attr != cudaSuccess) return dq_attr;
  const unsigned n_tiles = static_cast<unsigned>((T + 63) / 64);
  if (parts & kPartDq) {
    fa_bwd_dq_kernel<HD><<<n_tiles * Hq * B, kThreads, DqSmem<HD>::kBytes,
                           st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), seg, ranges,
        static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq), B,
        T, Hq, Hkv, n_rt, scale, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  static const cudaError_t kv_attr = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvSmem<HD>::kBytes);
  if (kv_attr != cudaSuccess) return kv_attr;
  if (parts & kPartDkdv) {
    fa_bwd_dkdv_kernel<HD><<<n_tiles * Hq * B, kThreads,
                             DkvSmem<HD>::kBytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), seg, ranges,
        static_cast<const bf16*>(dout), lse, D, dk_ws, dv_ws, B, T, Hq, Hkv,
        n_rt, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & kPartReduce) {
    const long long kv_rows = (long long)B * T * Hkv;
    const long long threads = kv_rows * (HD / 4);
    fa_bwd_reduce_kernel<HD><<<static_cast<unsigned>((threads + 255) / 256),
                               256, 0, st>>>(
        dk_ws, dv_ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        kv_rows, Hq / Hkv, scale);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// Forward.  Tensors are bf16 (q, k, v, out), int32 (seg, ranges), f32
// (lse); `ranges` is a [B, ceil(T/32), 2] workspace the forward fills and
// the backward reads.  hd is 64 or 128.  Returns the first CUDA error
// (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* seg, int* ranges, void* out, float* lse,
                        int B, int T, int Hq, int Hkv, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return static_cast<int>(
          fwd_typed<64>(q, k, v, seg, ranges, out, lse, B, T, Hq, Hkv, st));
    case 128:
      return static_cast<int>(
          fwd_typed<128>(q, k, v, seg, ranges, out, lse, B, T, Hq, Hkv, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: D = rowsum(dout * out) into the f32 workspace D [B, Hq, T];
// dq; the dk/dv partials of each query head into the f32 workspaces
// dk_ws, dv_ws [B, T, Hq, hd]; then their fixed-order sum over each
// group into dk, dv (no atomics).  `parts` selects the kernels that run
// (bits 1 D, 2 dq, 4 dk/dv, 8 reduce; 15 for a backward), so each can be
// timed alone.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const int* seg, const int* ranges, const void* out,
                        const void* dout, const float* lse, float* D,
                        float* dk_ws, float* dv_ws, void* dq, void* dk,
                        void* dv, int B, int T, int Hq, int Hkv, int hd,
                        int parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return static_cast<int>(bwd_typed<64>(q, k, v, seg, ranges, out, dout,
                                            lse, D, dk_ws, dv_ws, dq, dk, dv,
                                            B, T, Hq, Hkv, parts, st));
    case 128:
      return static_cast<int>(bwd_typed<128>(q, k, v, seg, ranges, out, dout,
                                             lse, D, dk_ws, dv_ws, dq, dk,
                                             dv, B, T, Hq, Hkv, parts, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
