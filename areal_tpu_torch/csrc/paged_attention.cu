// Paged flash-attention partials for NVIDIA Hopper (sm_90a): a decode
// entry on CUDA cores and a prefill-chunk entry on the tensor cores.
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
// What bounds it on an H100.  Each call must read sum_b lengths[b] * Hkv *
// 2 (K and V) * (hd * itemsize + scale bytes) of cache and does 4 * Q * Hq
// * hd flops per cached token.  Decode (Q = 1) is bound by HBM bytes: at
// the main path's 16 rows of up to 32768 tokens (Hkv = 2, hd = 128) one
// layer's call moves up to 537 MB from a bf16 pool (0.160 ms at 3.35 TB/s)
// or 277 MB from an int8 pool (0.083 ms).  A prefill chunk (Q = 512) does
// 512x more arithmetic per byte and is bound by operations: 2.9e10 flops
// at the main path's 8-row prefill shape, 0.030 ms on the bf16 tensor
// cores, 0.44 ms at the card's 67 TFLOP/s of f32 on CUDA cores.
//
// Decode entry (`paged_attention_fwd`; every q/pool type; the wrapper
// sends it the calls with one query token per row, and those over fp32
// or fp16):
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
//   scale right after the load, so the dots stay float32.
// * The warps' partials merge once in shared memory at the end.
// * Decode has few (row, head) pairs (B * Hkv blocks), too few to keep
//   HBM busy, so the wrapper splits the key range over `n_splits` blocks
//   and a second small kernel merges their partials.
// * Scores and softmax are float32 (expf), as the reference's
//   HIGHEST-precision dots.
//
// Prefill entry (`paged_attention_prefill_fwd`; bf16 q over a bf16 or an
// int8 pool, the calls with more than one query token per row):
// * A block (one warpgroup) owns (row b, KV head h, tile of kPfRows = 64
//   grouped query rows, key split).  The Q tile stays in shared memory
//   for the whole key loop, so each K/V byte serves 64 query rows (the
//   decode entry's 8): a 512-token chunk's 3072 grouped rows per (row, KV
//   head) re-read the prefix 48 times, not 384.
// * K and V stream through a two-stage `cp.async` ring of 64-key tiles
//   (one table lookup per tile when a page holds whole tiles, else one
//   per key; keys past the length are zero-filled, not read): tile i + 1
//   lands while tile i is multiplied.  bf16 rows land in the 128-byte
//   swizzle layout `wgmma` reads; an int8 stage carries raw rows and the
//   tile's K and V scales, and its values are widened to bf16 (exact:
//   |v| <= 127, by a float-bias trick) into swizzled work tiles.
// * QK^T on `wgmma` m64n64k16 (Q and K both from shared memory): bf16
//   operands with f32 accumulation, so every product is exact as in the
//   reference's f32 dot; an int8 pool's K scale multiplies its score
//   column after the product.
// * P.V at the reference's precision: P (f32; for an int8 pool already
//   multiplied by its key's V scale) is split into P_hi = bf16(P) and P_lo
//   = bf16(P - P_hi), and P_hi V + P_lo V accumulate in f32 (`wgmma`
//   with P from registers and V read MN-major), so P keeps about 16
//   mantissa bits.  Rounding P to bf16 alone would err near 2^-9.
// * Online softmax in f32 in the log2 domain (`ex2.approx` of pre-scaled
//   scores); m is reported in natural units.
// * A chunk over a long prefix has few query tiles (96 blocks at one
//   512-token row), so the wrapper splits the key range to fill the card
//   and the decode entry's merge kernel combines the splits.
//
// Plain C interface, bound from Python with ctypes
// (areal_tpu_torch/ops/paged_attention.py); no PyTorch headers.

#include "mma_common.cuh"
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

// ---- the prefill entry: tensor cores ----------------------------------------

constexpr int kPfThreads = 128;  // one warpgroup
constexpr int kPfRows = 64;      // grouped query rows per block (wgmma M)
constexpr int kPfKeys = 64;      // keys per ring stage
constexpr int kPfStages = 2;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// Four int8 values (a 32-bit word, lowest byte first) -> bf16 pairs
// (e0, e1) and (e2, e3), exactly: e + 128 goes into the low mantissa byte
// of the float 2^23, and subtracting 2^23 + 128 leaves e.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias;
  lo = tc::pack_bf16(f0, f1);
  hi = tc::pack_bf16(f2, f3);
}

// Shared-memory plan (byte offsets from a 1024-aligned base): the Q tile
// and, per ring stage, the K and V rows (bf16 pools: the swizzled bf16
// tiles wgmma reads; int8 pools: raw rows and their scales, widened into
// the two swizzled work tiles).
template <typename Tk, int HD>
struct PfLayout {
  static constexpr bool kQuant = std::is_same<Tk, int8_t>::value;
  static constexpr int kTile = 64 * HD * 2;  // a 64-row bf16 tile
  static constexpr int kRowChunks = HD * static_cast<int>(sizeof(Tk)) / 16;
  static constexpr int kRawTile = kPfKeys * HD * static_cast<int>(sizeof(Tk));
  static constexpr int kScales = kQuant ? 2 * kPfKeys * 4 : 0;
  static constexpr int kStage = (2 * kRawTile + kScales + 1023) / 1024 * 1024;
  static constexpr int kRing = kTile;
  static constexpr int kWork = kRing + kPfStages * kStage;
  static constexpr int kBytes = kWork + (kQuant ? 2 * kTile : 0);
  static constexpr int kSmem = kBytes + 1024;  // + alignment slack
  // accumulator: HD columns in chunks of one wgmma's N
  static constexpr int kN = HD >= 128 ? 128 : 64;
  static constexpr int kChunks = HD / kN;
};

template <typename Tk, int HD>
__global__ void __launch_bounds__(kPfThreads, 2)
paged_prefill_kernel(const bf16* __restrict__ q, const Tk* __restrict__ k_pool,
                     const Tk* __restrict__ v_pool,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ tables,
                     const int* __restrict__ lengths,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Q, int Hq, int Hkv, int BS,
                     int MB, int NB, int n_splits, long long sb, long long sh,
                     long long ss, long long ssb, long long ssh,
                     float scale_log2) {
  using Lay = PfLayout<Tk, HD>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int kN = Lay::kN, kChunks = Lay::kChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-aligned base: the swizzle pattern follows absolute address bits
  unsigned char* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* ring = smem + Lay::kRing;
  unsigned char* work = smem + Lay::kWork;

  const int r = Hq / Hkv;
  const int qtile = blockIdx.x / n_splits;
  const int split = blockIdx.x % n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_rows_total = Q * r;
  const int row0 = qtile * kPfRows;

  // the query tile (bf16) -> swizzled shared memory; padding rows are zero
  for (int idx = threadIdx.x; idx < kPfRows * (HD / 8); idx += kPfThreads) {
    const int i = idx / (HD / 8), c = idx % (HD / 8), gr = row0 + i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n_rows_total) {
      const int t = gr / r, j = gr % r;
      v = *reinterpret_cast<const uint4*>(
          q + (((long long)b * Q + t) * Hq + h * r + j) * HD + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + tc::swz_offset(kPfRows, i, c * 8)) = v;
  }
  tc::fence_proxy_async();

  const int length = max(0, min(lengths[b], MB * BS));
  const int n_tiles = (length + kPfKeys - 1) / kPfKeys;
  const int per_split = (n_tiles + n_splits - 1) / n_splits;
  const int t_begin = split * per_split;
  const int n = max(0, min(n_tiles, t_begin + per_split) - t_begin);
  const int* table = tables + (long long)b * MB;

  // a page holds whole 64-key tiles (the usual page sizes): one table
  // lookup per tile instead of one per key
  const bool whole = BS % kPfKeys == 0;
  // the pool offset of key `pos` (in elements; scales: `scale_off`)
  auto key_off = [&](int pos, long long& scale_off) {
    const int page = min(max(table[pos / BS], 0), NB - 1);
    scale_off = page * ssb + h * ssh + pos % BS;
    return page * sb + h * sh + (long long)(pos % BS) * ss;
  };

  // copy tile `tile`'s keys into ring stage `slot`; keys past the length
  // are zero-filled (finite, and their probabilities are 0).  A thread
  // copies 16-byte piece c16 of keys key0 + kPass p.
  constexpr int kPass = kPfThreads / Lay::kRowChunks;
  const int key0 = threadIdx.x / Lay::kRowChunks;
  const int c16 = threadIdx.x % Lay::kRowChunks;
  auto load_stage = [&](int tile, int slot) {
    unsigned char* st = ring + slot * Lay::kStage;
    const int base = tile * kPfKeys;
    long long tile_soff = 0;
    const long long tile_off = whole ? key_off(base, tile_soff) : 0;
#pragma unroll
    for (int p = 0; p < kPfKeys / kPass; ++p) {
      const int key = key0 + p * kPass;
      const int pos = base + key;
      const bool valid = pos < length;
      long long off = 0, soff;
      if (valid) off = whole ? tile_off + key * ss : key_off(pos, soff);
      // bf16: straight into the swizzled tile; int8: raw rows
      const int dst = kQuant ? key * HD + c16 * 16
                             : tc::swz_offset(kPfKeys, key, c16 * 8);
      tc::cp_async16(st + dst,
                     reinterpret_cast<const unsigned char*>(k_pool + off) + c16 * 16,
                     valid);
      tc::cp_async16(st + Lay::kRawTile + dst,
                     reinterpret_cast<const unsigned char*>(v_pool + off) + c16 * 16,
                     valid);
    }
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * Lay::kRawTile);
      for (int key = threadIdx.x; key < kPfKeys; key += kPfThreads) {
        const int pos = base + key;
        const bool valid = pos < length;
        long long so = 0;
        if (valid) {
          if (whole) so = tile_soff + key;
          else key_off(pos, so);
        }
        tc::cp_async4(sc + key, k_scale + so, valid);
        tc::cp_async4(sc + kPfKeys + key, v_scale + so, valid);
      }
    }
  };

  // online-softmax state of rows g and g + 8 of the warp (log2 domain)
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kChunks][kN / 2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) acc[c][x] = 0.f;

  for (int s = 0; s < kPfStages - 1; ++s) {
    if (s < n) load_stage(t_begin + s, s);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<kPfStages - 2>();
    tc::fence_proxy_async();
    __syncthreads();  // tile i landed for all; tile i-1's stage is free
    const int nxt = i + kPfStages - 1;
    if (nxt < n) load_stage(t_begin + nxt, nxt % kPfStages);
    tc::cp_async_commit();

    const unsigned char* st = ring + (i % kPfStages) * Lay::kStage;
    const unsigned char* Ks = st;
    const unsigned char* Vs = st + Lay::kRawTile;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (kQuant) {
      // widen the stage's int8 K and V to bf16 in the swizzled work tiles
      for (int idx = threadIdx.x; idx < 2 * kPfKeys * Lay::kRowChunks;
           idx += kPfThreads) {
        const int which = idx / (kPfKeys * Lay::kRowChunks);
        const int rem = idx % (kPfKeys * Lay::kRowChunks);
        const int key = rem / Lay::kRowChunks, c = rem % Lay::kRowChunks;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            st + which * Lay::kRawTile + key * HD + c * 16);
        uint32_t o[8];
        i8x4_to_bf16x4(raw.x, o[0], o[1]);
        i8x4_to_bf16x4(raw.y, o[2], o[3]);
        i8x4_to_bf16x4(raw.z, o[4], o[5]);
        i8x4_to_bf16x4(raw.w, o[6], o[7]);
        unsigned char* dst = work + which * Lay::kTile;
        *reinterpret_cast<uint4*>(dst + tc::swz_offset(kPfKeys, key, c * 16)) =
            make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(dst + tc::swz_offset(kPfKeys, key, c * 16 + 8)) =
            make_uint4(o[4], o[5], o[6], o[7]);
      }
      tc::fence_proxy_async();
      __syncthreads();
      Ks = work;
      Vs = work + Lay::kTile;
      ksc = reinterpret_cast<const float*>(st + 2 * Lay::kRawTile);
      vsc = ksc + kPfKeys;
    }
    const int n_valid = min(kPfKeys, length - (t_begin + i) * kPfKeys);

    // S = Q K^T: 64 rows x 64 keys, s[4j + x] holds row g + 8 (x >> 1),
    // key 8j + 2tq + (x & 1) of this warp's 16 rows
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk >> 2) * kPfKeys * 128 + (kk & 3) * 32;
      tc::wgmma_64x64_ss(s, tc::wg_desc(q_s + off, 16, 1024),
                         tc::wg_desc(Ks + off, 16, 1024));
    }
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::wg_fence_acc(s);

    // scale (and K scale), mask past the length, online softmax
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + tq * 2 + c;
        const bool ok = col < n_valid;
        float f = scale_log2;
        if constexpr (kQuant) f = ok ? ksc[col] * scale_log2 : 0.f;
        s[4 * j + c] = ok ? s[4 * j + c] * f : kNegInf;
        s[4 * j + 2 + c] = ok ? s[4 * j + 2 + c] * f : kNegInf;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + hr * 2], s[4 * j + hr * 2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m2[hr], mx);  // finite: >= 1 valid key
      const float alpha = tc::exp2_approx(m2[hr] - m_new);  // 0 on the 1st tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = tc::exp2_approx(s[4 * j + hr * 2 + c] - m_new);  // 0 masked
          s[4 * j + hr * 2 + c] = p;
          rs += p;
        }
      }
      m2[hr] = m_new;
      l[hr] = l[hr] * alpha + rs;  // this thread's columns; summed at the end
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          acc[c][4 * j + hr * 2] *= alpha;
          acc[c][4 * j + hr * 2 + 1] *= alpha;
        }
    }
    // O += P V with P = P_hi + P_lo (int8: P times the key's V scale
    // first); the A fragments of all four 16-key steps stay in registers
    // until the products are done
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kc = 0; kc < kPfKeys / 16; ++kc) {
      float p[8];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[x] = s[8 * kc + x];
        p[4 + x] = s[8 * kc + 4 + x];
      }
      if constexpr (kQuant) {
#pragma unroll
        for (int x = 0; x < 8; ++x)
          p[x] *= vsc[kc * 16 + (x >> 2) * 8 + tq * 2 + (x & 1)];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * x], p[2 * x + 1]);
        const float2 hf = __bfloat1622float2(hi);
        ahi[kc][x] = *reinterpret_cast<const uint32_t*>(&hi);
        alo[kc][x] = tc::pack_bf16(p[2 * x] - hf.x, p[2 * x + 1] - hf.y);
      }
    }
    tc::wg_fence();
#pragma unroll
    for (int kc = 0; kc < kPfKeys / 16; ++kc) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t db =
            tc::wg_desc(Vs + kc * 16 * 128 + c * 2 * kPfKeys * 128,
                        kPfKeys * 128, 1024);
        tc::wgmma_rs<kN>(acc[c], ahi[kc], db);
        tc::wgmma_rs<kN>(acc[c], alo[kc], db);
      }
    }
    tc::wg_commit();
    tc::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) tc::wg_fence_acc(acc[c]);
  }
  tc::cp_async_wait<0>();

  const long long R = (long long)B * Q * Hq;  // rows of one split's output
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int gr = row0 + warp * 16 + g + hr * 8;
    if (gr >= n_rows_total) continue;
    const int t = gr / r, j = gr % r;
    const long long row = split * R + ((long long)b * Q + t) * Hq + h * r + j;
    float* o = acc_out + row * HD;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int jn = 0; jn < kN / 8; ++jn)
        *reinterpret_cast<float2*>(o + c * kN + jn * 8 + tq * 2) =
            make_float2(acc[c][4 * jn + hr * 2], acc[c][4 * jn + hr * 2 + 1]);
    if (tq == 0) {
      m_out[row] = m2[hr] == kNegInf ? kNegInf : m2[hr] * kLn2;
      l_out[row] = lt;
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

// The prefill entry: arguments as paged_attention_fwd, for bf16 q (q_dtype
// 1) over a bf16 (pool_dtype 1) or int8 (3) pool; the wrapper sends it
// the calls with more than one query token per row.  With n_splits > 1
// the partials land in the workspace buffers and the merge kernel
// combines them.  Returns the first CUDA error (0 = success).
int paged_attention_prefill_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, float* acc, float* m, float* l, float* acc_ws,
    float* m_ws, float* l_ws, int B, int Q, int Hq, int Hkv, int hd, int BS,
    int MB, int NB, int n_splits, long long sb, long long sh, long long ss,
    long long ssb, long long ssh, int q_dtype, int pool_dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype != 1 || (pool_dtype != 1 && pool_dtype != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  float* a_dst = n_splits > 1 ? acc_ws : acc;
  float* m_dst = n_splits > 1 ? m_ws : m;
  float* l_dst = n_splits > 1 ? l_ws : l;
  const int r = Hq / Hkv;
  const int n_qtiles = (Q * r + kPfRows - 1) / kPfRows;
  const dim3 grid(n_qtiles * n_splits, Hkv, B);
  auto run = [&](auto tk) {
    using Tk = decltype(tk);
    return paged::dispatch_hd(hd, [&](auto hd_c) -> cudaError_t {
      constexpr int HD = decltype(hd_c)::value;
      constexpr int smem = PfLayout<Tk, HD>::kSmem;
      static_assert(smem <= 227 * 1024, "prefill stage too large");
      auto kernel = paged_prefill_kernel<Tk, HD>;
      // above 48 KB a block's shared memory must be asked for, once
      static const cudaError_t attr = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return attr;
      kernel<<<grid, kPfThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const Tk*>(k_pool),
          static_cast<const Tk*>(v_pool), k_scale, v_scale, tables, lengths,
          a_dst, m_dst, l_dst, Q, Hq, Hkv, BS, MB, NB, n_splits, sb, sh, ss,
          ssb, ssh, scale_log2);
      return cudaGetLastError();
    });
  };
  cudaError_t err = pool_dtype == 3 ? run(int8_t{}) : run(bf16{});
  if (err != cudaSuccess || n_splits <= 1) return static_cast<int>(err);
  return static_cast<int>(paged::combine_splits(
      acc_ws, m_ws, l_ws, acc, m, l, static_cast<long long>(B) * Q * Hq, hd,
      n_splits, st));
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
