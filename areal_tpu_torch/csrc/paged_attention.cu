// Paged flash-attention partials for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_attention`
// (areal_tpu/ops/paged_attention.py:201; body `_kernel` :74, index map
// `_paged_kv_map` :138, numerics `softmax_block_update` in
// areal_tpu/ops/decode_attention.py:50).  Same contract: every query token
// of row b attends the row's whole cached prefix [0, lengths[b]), read
// through the row's block table, and the kernel emits UN-normalised
// online-softmax partials (acc, m, l) in float32.  A row with length 0
// yields acc = 0, l = 0, m = -1e30 exactly (the callers' online merge
// relies on it).
//
// Layouts: q [B, Q, Hq, hd]; pools [NB, Hkv, BS, hd] addressed through
// their block/head/slot strides (hd contiguous), so a layer slice of the
// stacked [L, NB, Hkv, BS, hd] pool is passed without a copy; tables
// [B, MB] int32; lengths [B] int32; acc [B, Q, Hq, hd], m and l [B, Q, Hq].
// An int8 pool comes with float32 scale pools [NB, Hkv, BS] (block and
// head strides, slots contiguous): one absmax scale per (block, head,
// slot), as the reference's `kv_cache_dtype="int8"` storage.
//
// What bounds it on an H100: HBM bytes.  Each call must read
// sum_b lengths[b] * Hkv * 2 (K and V) * (hd * itemsize + scale bytes)
// of cache; at the main path's decode shape (B = 16 rows of up to 32768
// tokens, Hkv = 2, hd = 128) one layer's call moves up to 537 MB from a
// bf16 pool (0.160 ms at 3.35 TB/s) or 277 MB from an int8 pool (0.083
// ms).  The arithmetic is 4 * Q * Hq * hd flops per cached token, so
// decode (Q = 1) sits far below the card's ops:byte ridge.  Prefill
// chunks (Q = 512) do 512x more arithmetic per byte and become bound by
// the float32 arithmetic this kernel does on CUDA cores (the reference
// keeps Precision.HIGHEST, i.e. f32 dot products, and so does this port).
//
// Design:
// * A thread block owns one (row b, KV head h, tile of kRows GQA query
//   rows, KV split).  The query rows of a tile are (token, head-in-group)
//   pairs that share KV head h, so each streamed K/V row serves all of
//   them (the TPU kernel's GQA grouping).
// * The block reads its own length and block table and walks only the
//   row's valid keys, 32 at a time (one key per lane).  The four warps
//   take interleaved 32-key tiles and keep private (m, l, acc) state in
//   registers; K and V go straight from global memory into registers (a
//   lane reads its key's K row for the scores; for P.V every lane reads
//   its hd/32 columns of each V row, so a warp reads a V row in one
//   coalesced access).  No shared-memory staging, no block-wide barrier
//   inside the key loop.
// * int8 pools (the TPU kernel's branch at
//   areal_tpu/ops/paged_attention.py:116-123): a lane loads its key's K
//   and V scales beside the row and multiplies each int8 element by its
//   scale right after the load, so the dots stay float32 as in the fp
//   path.  K rows load 8 int8 values (8 bytes) at a time.
// * The warps' partials merge once in shared memory at the end.
// * Decode has few (row, head) pairs (B * Hkv blocks), too few to keep
//   HBM busy, so the wrapper splits the key range over `n_splits` blocks
//   and a second small kernel merges their partials.  Prefill chunks have
//   enough query tiles and run with n_splits = 1.
// * Scores and softmax are float32 (expf, not __expf), as the reference's
//   HIGHEST-precision dots.
//
// Plain C interface, bound from Python with ctypes
// (areal_tpu_torch/ops/paged_attention.py); no PyTorch headers.

#include "paged_common.cuh"

namespace {

using paged::kFull;
using paged::kNegInf;
using paged::load_f32;
using paged::to_f32;
using paged::warp_max;
using paged::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;   // query rows per block
constexpr int kTile = 32;  // keys per warp tile: one per lane

// ---- the partials kernel -------------------------------------------------

template <typename Tq, typename Tk, int HD>
__global__ void __launch_bounds__(kThreads)
paged_partials_kernel(const Tq* __restrict__ q, const Tk* __restrict__ k_pool,
                      const Tk* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,
                      const int* __restrict__ lengths,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int Q, int Hq, int Hkv,
                      int BS, int MB, int NB, int n_splits, long long sb,
                      long long sh, long long ss, long long ssb,
                      long long ssh, float scale) {
  constexpr bool kQuant = std::is_same<Tk, int8_t>::value;
  constexpr int CPL = HD / 32;  // acc columns per lane
  __shared__ __align__(16) float q_s[kRows][HD];
  __shared__ float red_m[kWarps][kRows];
  __shared__ float red_l[kWarps][kRows];
  __shared__ __align__(16) float red_acc[kWarps][kRows][HD];

  const int r = Hq / Hkv;
  const int qtile = blockIdx.x / n_splits;
  const int split = blockIdx.x % n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_rows_total = Q * r;
  const int row0 = qtile * kRows;

  // query tile -> float32 shared memory; padding rows are zero
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    float v = 0.f;
    if (gr < n_rows_total) {
      const int t = gr / r, j = gr % r;
      v = to_f32(q[(((long long)b * Q + t) * Hq + h * r + j) * HD + d]);
    }
    q_s[i][d] = v;
  }
  __syncthreads();

  const int length = max(0, min(lengths[b], MB * BS));
  const int n_tiles = (length + kTile - 1) / kTile;
  const int per_split = (n_tiles + n_splits - 1) / n_splits;
  const int t_begin = split * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);
  const int* table = tables + (long long)b * MB;

  float m[kRows], l[kRows], acc[kRows][CPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }

  for (int tile = t_begin + warp; tile < t_end; tile += kWarps) {
    const int pos = tile * kTile + lane;
    const bool valid = pos < length;
    long long off = 0;
    float vsc = 1.f;  // this lane's key's V scale (int8 pools)
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    if (valid) {
      int page = table[pos / BS];
      page = min(max(page, 0), NB - 1);
      off = page * sb + h * sh + (long long)(pos % BS) * ss;
      float ksc = 1.f;
      if constexpr (kQuant) {
        const long long so = page * ssb + h * ssh + pos % BS;
        ksc = k_scale[so];
        vsc = v_scale[so];
      }
      const Tk* kp = k_pool + off;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kf[8];
        load_f32<Tk, 8>(kp + d0, kf);
        if constexpr (kQuant) {
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] *= ksc;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 qa = *reinterpret_cast<const float4*>(&q_s[i][d0]);
          const float4 qb = *reinterpret_cast<const float4*>(&q_s[i][d0 + 4]);
          float a = s[i];
          a = fmaf(qa.x, kf[0], a); a = fmaf(qa.y, kf[1], a);
          a = fmaf(qa.z, kf[2], a); a = fmaf(qa.w, kf[3], a);
          a = fmaf(qb.x, kf[4], a); a = fmaf(qb.y, kf[5], a);
          a = fmaf(qb.z, kf[6], a); a = fmaf(qb.w, kf[7], a);
          s[i] = a;
        }
      }
    }
    // online-softmax update over this tile (the tile holds >= 1 valid key)
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float sv = valid ? s[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sv));
      p[i] = expf(sv - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= alpha;
    }
    // P.V: key k's offset, scale and probabilities come from lane k
    const int n_keys = min(kTile, length - tile * kTile);
    for (int k = 0; k < n_keys; ++k) {
      const long long off_k = __shfl_sync(kFull, off, k);
      float vf[CPL];
      load_f32<Tk, CPL>(v_pool + off_k + lane * CPL, vf);
      if constexpr (kQuant) {
        const float vs_k = __shfl_sync(kFull, vsc, k);
#pragma unroll
        for (int c = 0; c < CPL; ++c) vf[c] *= vs_k;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pk = __shfl_sync(kFull, p[i], k);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(pk, vf[c], acc[i][c]);
      }
    }
  }

  // merge the warps' partials
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (lane == 0) {
      red_m[warp][i] = m[i];
      red_l[warp][i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) red_acc[warp][i][lane * CPL + c] = acc[i][c];
  }
  __syncthreads();
  const long long R = (long long)B * Q * Hq;  // rows of one split's output
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    if (gr >= n_rows_total) continue;
    float M = red_m[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w][i]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(red_m[w][i] - M);
      a += red_acc[w][i][d] * e;
      L += red_l[w][i] * e;
    }
    const int t = gr / r, j = gr % r;
    const long long row = split * R + ((long long)b * Q + t) * Hq + h * r + j;
    acc_out[row * HD + d] = a;
    if (d == 0) {
      m_out[row] = M;
      l_out[row] = L;
    }
  }
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16; pool_dtype: the same
// code as q, or 3 = int8 with float32 scale pools k_scale/v_scale (block
// and head strides ssb/ssh, slots contiguous; null for fp pools).
// With n_splits > 1 the partials land in the workspace buffers
// ([n_splits, B*Q*Hq, hd] and [n_splits, B*Q*Hq]) and a second kernel
// merges them into acc/m/l.  Returns the first CUDA error (0 = success).
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* lengths, float* acc,
                        float* m, float* l, float* acc_ws, float* m_ws,
                        float* l_ws, int B, int Q, int Hq, int Hkv, int hd,
                        int BS, int MB, int NB, int n_splits, long long sb,
                        long long sh, long long ss, long long ssb,
                        long long ssh, int q_dtype, int pool_dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  float* a_dst = n_splits > 1 ? acc_ws : acc;
  float* m_dst = n_splits > 1 ? m_ws : m;
  float* l_dst = n_splits > 1 ? l_ws : l;
  const int r = Hq / Hkv;
  const int n_qtiles = (Q * r + kRows - 1) / kRows;
  const dim3 grid(n_qtiles * n_splits, Hkv, B);
  cudaError_t err = paged::dispatch_types(
      q_dtype, pool_dtype, [&](auto tq, auto tk) {
        using Tq = decltype(tq);
        using Tk = decltype(tk);
        return paged::dispatch_hd(hd, [&](auto hd_c) {
          constexpr int HD = decltype(hd_c)::value;
          paged_partials_kernel<Tq, Tk, HD><<<grid, kThreads, 0, st>>>(
              static_cast<const Tq*>(q), static_cast<const Tk*>(k_pool),
              static_cast<const Tk*>(v_pool), k_scale, v_scale, tables,
              lengths, a_dst, m_dst, l_dst, Q, Hq, Hkv, BS, MB, NB, n_splits,
              sb, sh, ss, ssb, ssh, scale);
          return cudaGetLastError();
        });
      });
  if (err != cudaSuccess || n_splits <= 1) return static_cast<int>(err);
  return static_cast<int>(paged::combine_splits(
      acc_ws, m_ws, l_ws, acc, m, l, static_cast<long long>(B) * Q * Hq, hd,
      n_splits, st));
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
