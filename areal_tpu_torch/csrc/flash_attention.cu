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
// each 32-token tile).
//
// Arithmetic: bf16 tensor-core products (`mma.sync` m16n8k16, bf16
// operands, f32 accumulation), as the TPU kernel's bf16-operand /
// f32-accumulate dots; the online softmax, lse and D are f32.  The
// probabilities P and dS are rounded to bf16 before their products with
// V, dO, K and Q, as on the TPU.
//
// What bounds it on an H100: operations.  The forward does 4 * Hq * hd
// flops per attended (i, j) pair (QK^T and PV), the backward 10 (QK^T
// recomputed, dO V^T, P^T dO, dS^T Q, dS K); at a 4096-token row that is
// ~900 flops per byte of q/k/v, far right of the card's ~295 flop/byte
// ridge.  What the design does about it:
// * tensor cores (`mma.sync`), not CUDA-core FMAs, for every product;
// * tiles that lie wholly above the diagonal or outside every segment of
//   the other side's tile are skipped (a per-32-token-tile [min, max]
//   segment-id table, built by a small kernel, decides), so a packed row
//   costs ~sum L_s^2 instead of T^2;
// * the forward walks query tiles heaviest first (most keys to visit);
// * dk/dv: a block owns a key tile of one KV head and loops over query
//   tiles AND the Hq / Hkv query heads of its group, so GQA needs no
//   atomics and the gradients are bit-for-bit repeatable.
// Still to do (later work): wgmma, TMA and a multi-stage copy pipeline;
// loads here are plain 16-byte vector loads into shared memory between
// two barriers, so the tensor cores idle while a tile loads.
//
// Plain C interface, bound from Python with ctypes
// (areal_tpu_torch/ops/flash_attention.py); no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kRangeTile = 32;  // granularity of the segment-range table
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 at consecutive addresses (lower address in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 one row apart (strided), packed as a pair
__device__ __forceinline__ uint32_t ld_strided(const bf16* p, int stride) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// A fragment (16 rows x 16 k) of a row-major bf16 tile in shared memory:
// rows r0.., columns k0.., leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int k0, int g,
                                       int tq) {
  const bf16* p = s + (r0 + g) * ld + k0 + tq * 2;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// A fragment from two f32 accumulator n-tiles (16 rows x 8 cols each),
// which together cover 16 consecutive k.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy `rows` rows of `HD` bf16 (global row r at base + r * gstride) into
// shared memory (row r at s + r * ld); rows at or past `valid` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, int ld, const bf16* base,
                                          long long gstride, int rows,
                                          int valid) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(base + r * gstride + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

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

// ---- forward ----------------------------------------------------------------

// One block: (query tile of 64, query head h, row b).  Warp w owns query
// rows 16w..16w+15 of the tile; thread (g = lane / 4, tq = lane % 4) holds
// rows g and g + 8 of the warp's 16.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ seg,
              const int* __restrict__ ranges, bf16* __restrict__ out,
              float* __restrict__ lse, int T, int Hq, int Hkv, int n_rt,
              float scale_log2) {
  constexpr int BM = 64, BN = 64, LD = HD + 8, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + BN * LD;
  int* segq = reinterpret_cast<int*>(Vs + BN * LD);
  int* segk = segq + BM;

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * BM;
  const int* rng = ranges + (long long)b * n_rt * 2;
  const int2 qr = tile_range(rng, n_rt, q0 / kRangeTile, BM / kRangeTile);

  const long long qstride = (long long)Hq * HD;
  const long long kstride = (long long)Hkv * HD;
  load_tile<HD>(Qs, LD, q + ((long long)b * T + q0) * qstride + h * HD,
                qstride, BM, T - q0);
  for (int i = threadIdx.x; i < BM; i += kThreads)
    segq[i] = q0 + i < T ? seg[(long long)b * T + q0 + i] : 0;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int wr = warp * 16;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BN;
    if (!ranges_meet(qr, tile_range(rng, n_rt, k0 / kRangeTile,
                                    BN / kRangeTile)))
      continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(Ks, LD, k + ((long long)b * T + k0) * kstride + hk * HD,
                  kstride, BN, T - k0);
    load_tile<HD>(Vs, LD, v + ((long long)b * T + k0) * kstride + hk * HD,
                  kstride, BN, T - k0);
    for (int i = threadIdx.x; i < BN; i += kThreads)
      segk[i] = k0 + i < T ? seg[(long long)b * T + k0 + i] : 0;
    __syncthreads();

    // S = Q K^T, 16 x 64 per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, wr, kk * 16, g, tq);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* p = Ks + (n * 8 + g) * LD + kk * 16 + tq * 2;
        mma_bf16(s[n], a, ld_pair(p), ld_pair(p + 8));
      }
    }
    // mask, online softmax (log2 domain)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wr + g + hr * 8;
      const int sq = segq[row];
      const int i = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + tq * 2 + c;
          const bool ok = sq != 0 && segk[col] == sq && k0 + col <= i;
          const float x = ok ? s[n][hr * 2 + c] * scale_log2 : -INFINITY;
          s[n][hr * 2 + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -INFINITY) {
        alpha = exp2f(m[hr] - m_new);  // 0 when m[hr] is -inf
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = s[n][hr * 2 + c];
            const float p = x == -INFINITY ? 0.f : exp2f(x - m_new);
            s[n][hr * 2 + c] = p;
            rs += p;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][hr * 2] = s[n][hr * 2 + 1] = 0.f;
      }
      m[hr] = m_new;
      l[hr] = l[hr] * alpha + rs;  // per-thread partial, reduced at the end
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][hr * 2] *= alpha;
        acc[n][hr * 2 + 1] *= alpha;
      }
    }
    // O += P V
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* p = Vs + (kc * 16 + tq * 2) * LD + n * 8 + g;
        mma_bf16(acc[n], a, ld_strided(p, LD), ld_strided(p + 8 * LD, LD));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int i = q0 + wr + g + hr * 8;
    if (i >= T) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    bf16* o = out + ((long long)b * T + i) * qstride + h * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8 + tq * 2) =
          __floats2bfloat162_rn(acc[n][hr * 2] * inv,
                                acc[n][hr * 2 + 1] * inv);
    }
    if (tq == 0)
      lse[((long long)b * Hq + h) * T + i] =
          lt > 0.f ? (m[hr] + log2f(lt)) * kLn2 : INFINITY;
  }
}

// ---- backward ---------------------------------------------------------------

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

// dq: one block per (query tile of 64, query head, row), looping over the
// key tiles up to the diagonal.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const int* __restrict__ ranges, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 bf16* __restrict__ dq, int T, int Hq, int Hkv, int n_rt,
                 float scale, float scale_log2) {
  constexpr int BM = 64, BN = 64, LD = HD + 8, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;
  bf16* Vs = Ks + BN * LD;
  int* segq = reinterpret_cast<int*>(Vs + BN * LD);
  int* segk = segq + BM;
  float* lse_s = reinterpret_cast<float*>(segk + BN);
  float* D_s = lse_s + BM;

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * BM;
  const int* rng = ranges + (long long)b * n_rt * 2;
  const int2 qr = tile_range(rng, n_rt, q0 / kRangeTile, BM / kRangeTile);

  const long long qstride = (long long)Hq * HD;
  const long long kstride = (long long)Hkv * HD;
  const long long qoff = ((long long)b * T + q0) * qstride + h * HD;
  load_tile<HD>(Qs, LD, q + qoff, qstride, BM, T - q0);
  load_tile<HD>(dOs, LD, dout + qoff, qstride, BM, T - q0);
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const bool in = q0 + i < T;
    segq[i] = in ? seg[(long long)b * T + q0 + i] : 0;
    const long long li = ((long long)b * Hq + h) * T + q0 + i;
    lse_s[i] = in ? lse[li] * kLog2e : INFINITY;
    D_s[i] = in ? D[li] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int wr = warp * 16;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BN;
    if (!ranges_meet(qr, tile_range(rng, n_rt, k0 / kRangeTile,
                                    BN / kRangeTile)))
      continue;
    __syncthreads();
    load_tile<HD>(Ks, LD, k + ((long long)b * T + k0) * kstride + hk * HD,
                  kstride, BN, T - k0);
    load_tile<HD>(Vs, LD, v + ((long long)b * T + k0) * kstride + hk * HD,
                  kstride, BN, T - k0);
    for (int i = threadIdx.x; i < BN; i += kThreads)
      segk[i] = k0 + i < T ? seg[(long long)b * T + k0 + i] : 0;
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, Qs, LD, wr, kk * 16, g, tq);
      load_a(ad, dOs, LD, wr, kk * 16, g, tq);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* pk = Ks + (n * 8 + g) * LD + kk * 16 + tq * 2;
        mma_bf16(s[n], a, ld_pair(pk), ld_pair(pk + 8));
        const bf16* pv = Vs + (n * 8 + g) * LD + kk * 16 + tq * 2;
        mma_bf16(dp[n], ad, ld_pair(pv), ld_pair(pv + 8));
      }
    }
    // dS = P * (dP - D), P = exp(S - lse) on attended pairs, else 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wr + g + hr * 8;
      const int sq = segq[row];
      const int i = q0 + row;
      const float ls = lse_s[row], d = D_s[row];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + tq * 2 + c;
          const bool ok = sq != 0 && segk[col] == sq && k0 + col <= i;
          const float p = ok ? exp2f(s[n][hr * 2 + c] * scale_log2 - ls) : 0.f;
          s[n][hr * 2 + c] = p * (dp[n][hr * 2 + c] - d);
        }
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* p = Ks + (kc * 16 + tq * 2) * LD + n * 8 + g;
        mma_bf16(acc[n], a, ld_strided(p, LD), ld_strided(p + 8 * LD, LD));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + wr + g + hr * 8;
    if (i >= T) continue;
    bf16* o = dq + ((long long)b * T + i) * qstride + h * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8 + tq * 2) =
          __floats2bfloat162_rn(acc[n][hr * 2] * scale,
                                acc[n][hr * 2 + 1] * scale);
    }
  }
}

// dk, dv: one block per (key tile of 64, KV head, row), looping over the
// query heads of the KV head's group and, for each, over the query tiles
// of 32 at or below the diagonal.  Warp w owns keys 16w..16w+15 and holds
// S^T = K Q^T with keys as rows, so P^T and dS^T feed the dV and dK
// products straight from the accumulators.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   const int* __restrict__ ranges,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                   int Hq, int Hkv, int n_rt, float scale, float scale_log2) {
  constexpr int BN = 64, BQ = 32, LD = HD + 8, NT = HD / 8, NQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;
  bf16* dOs = Qs + BQ * LD;
  int* segk = reinterpret_cast<int*>(dOs + BQ * LD);
  int* segq = segk + BN;
  float* lse_s = reinterpret_cast<float*>(segq + BQ);
  float* D_s = lse_s + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int r = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = kt * BN;
  const int* rng = ranges + (long long)b * n_rt * 2;
  const int2 kr = tile_range(rng, n_rt, k0 / kRangeTile, BN / kRangeTile);
  const int n_qt = (T + BQ - 1) / BQ;

  const long long qstride = (long long)Hq * HD;
  const long long kstride = (long long)Hkv * HD;
  const long long koff = ((long long)b * T + k0) * kstride + hk * HD;
  load_tile<HD>(Ks, LD, k + koff, kstride, BN, T - k0);
  load_tile<HD>(Vs, LD, v + koff, kstride, BN, T - k0);
  for (int i = threadIdx.x; i < BN; i += kThreads)
    segk[i] = k0 + i < T ? seg[(long long)b * T + k0 + i] : 0;

  float dkacc[NT][4], dvacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
    dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
  }

  const int wr = warp * 16;
  for (int j = 0; j < r; ++j) {
    const int h = hk * r + j;
    for (int qt = k0 / BQ; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (!ranges_meet(kr, tile_range(rng, n_rt, q0 / kRangeTile,
                                      BQ / kRangeTile)))
        continue;
      __syncthreads();
      const long long qoff = ((long long)b * T + q0) * qstride + h * HD;
      load_tile<HD>(Qs, LD, q + qoff, qstride, BQ, T - q0);
      load_tile<HD>(dOs, LD, dout + qoff, qstride, BQ, T - q0);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < T;
        segq[i] = in ? seg[(long long)b * T + q0 + i] : 0;
        const long long li = ((long long)b * Hq + h) * T + q0 + i;
        lse_s[i] = in ? lse[li] * kLog2e : INFINITY;
        D_s[i] = in ? D[li] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries per warp
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], av[4];
        load_a(a, Ks, LD, wr, kk * 16, g, tq);
        load_a(av, Vs, LD, wr, kk * 16, g, tq);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const bf16* pq = Qs + (n * 8 + g) * LD + kk * 16 + tq * 2;
          mma_bf16(s[n], a, ld_pair(pq), ld_pair(pq + 8));
          const bf16* pd = dOs + (n * 8 + g) * LD + kk * 16 + tq * 2;
          mma_bf16(dp[n], av, ld_pair(pd), ld_pair(pd + 8));
        }
      }
      // P^T (kept in s) and dS^T (in dp)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = wr + g + hr * 8;
        const int sk = segk[key];
        const int jk = k0 + key;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n * 8 + tq * 2 + c;
            const int sq = segq[col];
            const bool ok = sq != 0 && sk == sq && jk <= q0 + col;
            const float p =
                ok ? exp2f(s[n][hr * 2 + c] * scale_log2 - lse_s[col]) : 0.f;
            s[n][hr * 2 + c] = p;
            dp[n][hr * 2 + c] = p * (dp[n][hr * 2 + c] - D_s[col]);
          }
        }
      }
      // dV += P^T dO ; dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s[2 * kc], s[2 * kc + 1]);
        acc_to_a(ads, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const bf16* pd = dOs + (kc * 16 + tq * 2) * LD + n * 8 + g;
          mma_bf16(dvacc[n], ap, ld_strided(pd, LD),
                   ld_strided(pd + 8 * LD, LD));
          const bf16* pq = Qs + (kc * 16 + tq * 2) * LD + n * 8 + g;
          mma_bf16(dkacc[n], ads, ld_strided(pq, LD),
                   ld_strided(pq + 8 * LD, LD));
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int jk = k0 + wr + g + hr * 8;
    if (jk >= T) continue;
    const long long off = ((long long)b * T + jk) * kstride + hk * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + tq * 2) =
          __floats2bfloat162_rn(dkacc[n][hr * 2] * scale,
                                dkacc[n][hr * 2 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + tq * 2) =
          __floats2bfloat162_rn(dvacc[n][hr * 2], dvacc[n][hr * 2 + 1]);
    }
  }
}

constexpr size_t fwd_smem(int hd) {
  return (3 * 64 * (hd + 8)) * sizeof(bf16) + 2 * 64 * sizeof(int);
}
constexpr size_t dq_smem(int hd) {
  return (4 * 64 * (hd + 8)) * sizeof(bf16) + 2 * 64 * sizeof(int) +
         2 * 64 * sizeof(float);
}
constexpr size_t dkdv_smem(int hd) {
  return (2 * 64 * (hd + 8) + 2 * 32 * (hd + 8)) * sizeof(bf16) +
         (64 + 32) * sizeof(int) + 2 * 32 * sizeof(float);
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
  const size_t smem = fwd_smem(HD);
  err = cudaFuncSetAttribute(fa_fwd_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + 63) / 64, Hq, B);
  fa_fwd_kernel<HD><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, ranges, static_cast<bf16*>(out), lse,
      T, Hq, Hkv, n_rt, scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_typed(const void* q, const void* k, const void* v,
                      const int* seg, const int* ranges, const void* out,
                      const void* dout, const float* lse, float* D, void* dq,
                      void* dk, void* dv, int B, int T, int Hq, int Hkv,
                      cudaStream_t st) {
  const int n_rt = (T + kRangeTile - 1) / kRangeTile;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const long long rows = (long long)B * T * Hq;
  const int warps = kThreads / 32;
  fa_bwd_dot_kernel<HD><<<static_cast<unsigned>((rows + warps - 1) / warps),
                          kThreads, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), D, B, T,
      Hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  size_t smem = dq_smem(HD);
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid_q((T + 63) / 64, Hq, B);
  fa_bwd_dq_kernel<HD><<<grid_q, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, ranges,
      static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq), T, Hq,
      Hkv, n_rt, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  smem = dkdv_smem(HD);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid_k((T + 63) / 64, Hkv, B);
  fa_bwd_dkdv_kernel<HD><<<grid_k, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, ranges,
      static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, Hq, Hkv, n_rt, scale, scale * kLog2e);
  return cudaGetLastError();
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

// Backward: D = rowsum(dout * out) into the f32 workspace D [B, Hq, T],
// then dq, then dk and dv (each written once, no atomics).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const int* seg, const int* ranges, const void* out,
                        const void* dout, const float* lse, float* D,
                        void* dq, void* dk, void* dv, int B, int T, int Hq,
                        int Hkv, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return static_cast<int>(bwd_typed<64>(q, k, v, seg, ranges, out, dout,
                                            lse, D, dq, dk, dv, B, T, Hq, Hkv,
                                            st));
    case 128:
      return static_cast<int>(bwd_typed<128>(q, k, v, seg, ranges, out, dout,
                                             lse, D, dq, dk, dv, B, T, Hq,
                                             Hkv, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
