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
// or fp16).  At the main path's 8-row decode shape (9302 cached tokens,
// 9.5 MB of a bf16 pool, 2.9 us at 3.35 TB/s) a call is bound by latency:
// a few round trips to device memory and a short key loop per block, not
// by bandwidth.  At 16 rows of 32768 tokens it is bound by bytes (bf16)
// and, for an int8 pool, close to the CUDA cores' issue rate (the dots
// run ~8 f32 FMAs per pool byte).  The design:
// * A thread block (4 warps) owns (row b, KV head h, KV split) with the
//   row's whole GQA group of query rows (R = 4, 6 or 8 rows, the
//   smallest that holds Q * Hq / Hkv; Q * Hq / Hkv > 8 takes tiles of 8),
//   so each staged K/V row serves all of them and Hq / Hkv = 6 has no
//   padding rows (the TPU kernel's GQA grouping).
// * Keys stream through a ring of 3-4 shared-memory stages of 64 keys
//   (16-byte `cp.async` pieces, consecutive threads on consecutive pieces
//   of a key row; one table lookup per tile when a page holds whole tiles,
//   else one per key; keys past the length are neither copied nor read),
//   so a block keeps its next tiles in flight while it computes one and
//   no device-memory load sits inside the key loop.  Rows are padded by
//   16 bytes: the 8 lanes of a quarter warp read 8 rows at one column on
//   distinct banks while their q reads are broadcasts.  The first tiles
//   are issued before the query rows are loaded.
// * Warp w takes 16 keys of each stage, 2 lanes per key each dotting half
//   of the row (f32 FMAs; an int8 pool's K scale multiplies the score), and
//   keeps its own online-softmax state in the log2 domain (`ex2.approx`
//   of pre-scaled scores; m reported in natural units).  P.V reads the
//   stage too: every lane owns hd/32 columns and walks the warp's 16 V
//   rows, the probabilities (times each key's V scale for an int8 pool)
//   broadcast from shared memory.  The warps' partials merge once in
//   shared memory at the end.
// * Splits come from shapes alone (the wrapper's `n_splits`: at least
//   256 keys each, one wave of two blocks per SM), and each split takes an
//   equal share of the row's live tiles; a split past the live length
//   exits at once.  The last live split of (row, KV head) to finish, found
//   by a ticket from a per-(row, KV head) counter that it resets, merges
//   every split's partials in split order (`paged::merge_live_splits`,
//   which the deep kernel's tensor-core body shares): one launch per
//   call, and the result is bit-identical on repeat.  A device value is never read on
//   the host and nothing is allocated by length.
// * The scores and P.V stay f32, as the reference's HIGHEST-precision
//   dots.

// Prefill entry (`paged_attention_prefill_fwd`; bf16 q over a bf16 or an
// int8 pool, the calls with more than one query token per row):
// * A block (one warpgroup) owns (row b, KV head h, tile of kPfRows = 64
//   grouped query rows, key split).  The Q tile stays in shared memory
//   for the whole key loop, so each K/V byte serves 64 query rows: a
//   512-token chunk's 3072 grouped rows per (row, KV head) re-read the
//   prefix 48 times.
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
//   and a second small kernel (paged_common.cuh) combines the splits.
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
using paged::kLn2;

// ---- the decode entry: a shared-memory copy ring ----------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 16;                  // bytes after each staged key row
constexpr int kRingBudget = 110 * 1024;   // bytes of ring per block

// Shared-memory plan of the decode entry (byte offsets): the R query rows
// (f32), each warp's probabilities of its keys, then a ring of stages of
// kKeys keys (K rows, V rows, padded by kPad bytes, and for an int8 pool
// their K and V scales).  The stage count follows a budget that lets two
// blocks share an SM, between 2 and 4.
template <typename Tk, int HD, int R>
struct DecLayout {
  static constexpr bool kQuant = std::is_same<Tk, int8_t>::value;
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(Tk));
  static constexpr int kKeys = kRowBytes > 512 ? 32 : 64;
  static constexpr int kWarpKeys = kKeys / kWarps;    // keys per warp
  static constexpr int kParts = 32 / kWarpKeys;       // lanes per key
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte pieces
  static constexpr int kRowStride = kRowBytes + kPad;
  static constexpr int kKBytes = kKeys * kRowStride;
  static constexpr int kStageBytes = 2 * kKBytes + (kQuant ? 2 * kKeys * 4 : 0);
  static constexpr int kStages =
      kRingBudget / kStageBytes < 2 ? 2
      : (kRingBudget / kStageBytes > 4 ? 4 : kRingBudget / kStageBytes);
  static constexpr int kQBytes = R * HD * 4;
  static constexpr int kPBytes = kWarps * kWarpKeys * 8 * 4;
  static constexpr int kRing = kQBytes + kPBytes;
  static constexpr int kRedBytes = kWarps * R * (HD + 2) * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kBytes =
      kRing + (kRingBytes > kRedBytes ? kRingBytes : kRedBytes);
  static_assert(kChunks % kParts == 0, "a key's lanes split its row evenly");
  static_assert(kBytes <= 227 * 1024, "decode stage too large");
};

// One block: (tile of R grouped query rows, KV split) of (KV head h, row
// b).  The split owns tiles [t_begin, t_begin + n) of the row's live keys
// (kKeys each), which stream through the copy ring; warp w takes keys
// [w kWarpKeys, (w + 1) kWarpKeys) of every tile with its own online-softmax
// state, merged across the warps at the end.  With several live splits
// the block writes its partials to the workspace, and the last split of
// (b, h, query tile) to finish merges them all in split order (a ticket
// from `counters`, which it resets), so a call is one launch.
template <typename Tq, typename Tk, int HD, int R>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const Tq* __restrict__ q, const Tk* __restrict__ k_pool,
                    const Tk* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_ws, float* __restrict__ m_ws,
                    float* __restrict__ l_ws, int* __restrict__ counters,
                    int Q, int Hq, int Hkv, int BS, int MB, int NB,
                    int n_splits, long long sb, long long sh, long long ss,
                    long long ssb, long long ssh, float scale_log2) {
  using Lay = DecLayout<Tk, HD, R>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int KT = Lay::kKeys, WK = Lay::kWarpKeys, PARTS = Lay::kParts;
  constexpr int NCP = Lay::kChunks / PARTS;  // chunks per lane of a key
  constexpr int E = 16 / static_cast<int>(sizeof(Tk));  // elements per chunk
  constexpr int CPL = HD / 32;  // acc columns per lane
  constexpr int S = Lay::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // [R][HD]
  float* p_s = reinterpret_cast<float*>(smem + Lay::kQBytes);  // [warp][WK][8]
  unsigned char* ring = smem + Lay::kRing;

  const int r = Hq / Hkv;
  const int n_qtiles = gridDim.x / n_splits;
  const int qtile = blockIdx.x / n_splits;
  const int split = blockIdx.x % n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows_total = Q * r;
  const int row0 = qtile * R;
  const long long R_all = (long long)B * Q * Hq;  // rows of one split

  const int length = max(0, min(lengths[b], MB * BS));
  const int n_tiles = (length + KT - 1) / KT;
  const int per_split = (n_tiles + n_splits - 1) / n_splits;
  const int n_live = per_split > 0 ? (n_tiles + per_split - 1) / per_split : 0;
  const int t_begin = split * per_split;
  const int n = max(0, min(n_tiles, t_begin + per_split) - t_begin);
  if (n == 0) {  // no live key: split 0 writes a length-0 row's result
    if (n_tiles == 0 && split == 0)
      paged::write_empty<kThreads, HD, R>(acc_out, m_out, l_out, row0,
                                          n_rows_total, Q, Hq, r, b, h);
    return;
  }
  // where this block's partials go: the outputs when it is the row's only
  // live split, else the workspace
  const bool direct = n_live == 1;
  float* a_dst = direct ? acc_out : acc_ws;
  float* m_dst = direct ? m_out : m_ws;
  float* l_dst = direct ? l_out : l_ws;
  const long long row_base = direct ? 0 : split * R_all;

  const int* table = tables + (long long)b * MB;
  // a page holds whole tiles (the usual page sizes): one table lookup per
  // tile instead of one per key
  const bool whole = BS % KT == 0;
  auto key_page = [&](int pos) { return min(max(table[pos / BS], 0), NB - 1); };

  // copy tile `tile`'s live keys into ring stage `slot` (keys past the
  // length are not copied and never read)
  auto load_stage = [&](int tile, int slot) {
    unsigned char* st = ring + slot * Lay::kStageBytes;
    const int base = tile * KT;
    const int n_valid = min(KT, length - base);
    // 16-byte cp.async pieces, consecutive threads on consecutive pieces
    // of a key row
    long long tile_off = 0, tile_soff = 0;
    if (whole) {
      const int page = key_page(base);
      tile_off = page * sb + h * sh + (long long)(base % BS) * ss;
      tile_soff = page * ssb + h * ssh + base % BS;
    }
    for (int idx = threadIdx.x; idx < n_valid * Lay::kChunks; idx += kThreads) {
      const int key = idx / Lay::kChunks, c = idx % Lay::kChunks;
      long long off;
      if (whole) {
        off = tile_off + key * ss;
      } else {
        const int pos = base + key;
        off = key_page(pos) * sb + h * sh + (long long)(pos % BS) * ss;
      }
      const int dst = key * Lay::kRowStride + c * 16;
      tc::cp_async16(st + dst,
                     reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
                     true);
      tc::cp_async16(st + Lay::kKBytes + dst,
                     reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
                     true);
    }
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * Lay::kKBytes);
      for (int key = threadIdx.x; key < n_valid; key += kThreads) {
        long long so;
        if (whole) {
          so = tile_soff + key;
        } else {
          const int pos = base + key;
          so = key_page(pos) * ssb + h * ssh + pos % BS;
        }
        tc::cp_async4(sc + key, k_scale + so, true);
        tc::cp_async4(sc + KT + key, v_scale + so, true);
      }
    }
  };

  // online-softmax state of the warp (log2 domain) for each query row
  float m[R], l[R], acc[R][CPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const int kk = lane % WK, part = lane / WK;
  float* pw = p_s + warp * WK * 8;

  // prologue: tiles 0 .. S-2 in flight (one cp.async group each, empty
  // groups included, so the group count stays uniform)
  for (int st = 0; st < S - 1; ++st) {
    if (st < n) load_stage(t_begin + st, st);
    tc::cp_async_commit();
  }
  // the query rows -> float32 shared memory (padding rows are zero),
  // while the first tiles are in flight; the first barrier below orders
  // them before their reads
  for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    float v = 0.f;
    if (gr < n_rows_total) {
      const int t = gr / r, j = gr % r;
      v = to_f32(q[(((long long)b * Q + t) * Hq + h * r + j) * HD + d]);
    }
    q_s[i * HD + d] = v;
  }
  for (int i = 0; i < n; ++i) {
    tc::cp_async_wait<S - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's did; the stage of tile i-1 is free
    const int nxt = i + S - 1;
    if (nxt < n) load_stage(t_begin + nxt, nxt % S);
    tc::cp_async_commit();

    const unsigned char* st = ring + (i % S) * Lay::kStageBytes;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * Lay::kKBytes);
    const int wbase = (t_begin + i) * KT + warp * WK;  // the warp's first key
    if (wbase >= length) continue;  // warp-uniform: no valid key here
    const int key = warp * WK + kk;  // key within the stage
    const bool valid = wbase + kk < length;

    // scores: the PARTS lanes of a key each dot NCP chunks of its row
    // (lanes of a quarter warp read 8 rows at one column: the padding puts
    // them on distinct banks, and q is a broadcast)
    float s[R];
#pragma unroll
    for (int i2 = 0; i2 < R; ++i2) s[i2] = 0.f;
    const unsigned char* krow = st + key * Lay::kRowStride;
#pragma unroll
    for (int c = 0; c < NCP; ++c) {
      const int chunk = part * NCP + c;
      float kf[E];
      load_f32<Tk, E>(reinterpret_cast<const Tk*>(krow + chunk * 16), kf);
#pragma unroll
      for (int i2 = 0; i2 < R; ++i2) {
        const float* qp = q_s + i2 * HD + chunk * E;
        float a = s[i2];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qp + e);
          a = fmaf(qv.x, kf[e], a);
          a = fmaf(qv.y, kf[e + 1], a);
          a = fmaf(qv.z, kf[e + 2], a);
          a = fmaf(qv.w, kf[e + 3], a);
        }
        s[i2] = a;
      }
    }
    const float f = kQuant ? ksc[key] * scale_log2 : scale_log2;
#pragma unroll
    for (int i2 = 0; i2 < R; ++i2) {
      float dot = s[i2];
#pragma unroll
      for (int o = WK; o < 32; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
      const float sv = valid ? dot * f : kNegInf;
      float mx = sv;
#pragma unroll
      for (int o = 1; o < WK; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i2], mx);  // finite: the warp has a valid key
      const float p = tc::exp2_approx(sv - m_new);  // 0 past the length
      float ps = p;
#pragma unroll
      for (int o = 1; o < WK; o <<= 1) ps += __shfl_xor_sync(kFull, ps, o);
      const float alpha = tc::exp2_approx(m[i2] - m_new);
      l[i2] = l[i2] * alpha + ps;
      m[i2] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i2][c] *= alpha;
      s[i2] = p;
    }
    if (part == 0) {
      const float vs = kQuant ? ksc[KT + key] : 1.f;
#pragma unroll
      for (int i2 = 0; i2 < R; ++i2) pw[kk * 8 + i2] = s[i2] * vs;
    }
    __syncwarp();
    // P.V: every lane reads its CPL columns of each of the warp's V rows
    const int n_keys = min(WK, length - wbase);
    const unsigned char* vst = st + Lay::kKBytes + warp * WK * Lay::kRowStride;
#pragma unroll 4
    for (int k2 = 0; k2 < n_keys; ++k2) {
      float vf[CPL];
      load_f32<Tk, CPL>(
          reinterpret_cast<const Tk*>(vst + k2 * Lay::kRowStride) + lane * CPL, vf);
      float pk[8];
      *reinterpret_cast<float4*>(pk) = *reinterpret_cast<const float4*>(pw + k2 * 8);
      *reinterpret_cast<float4*>(pk + 4) =
          *reinterpret_cast<const float4*>(pw + k2 * 8 + 4);
#pragma unroll
      for (int i2 = 0; i2 < R; ++i2)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i2][c] = fmaf(pk[i2], vf[c], acc[i2][c]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials merge there

  float* red_m = reinterpret_cast<float*>(ring);  // [kWarps][R]
  float* red_l = red_m + kWarps * R;              // [kWarps][R]
  float* red_acc = red_l + kWarps * R;            // [kWarps][R][HD]
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane == 0) {
      red_m[warp * R + i] = m[i];
      red_l[warp * R + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      red_acc[(warp * R + i) * HD + lane * CPL + c] = acc[i][c];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    if (gr >= n_rows_total) continue;
    float M = red_m[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w * R + i]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = tc::exp2_approx(red_m[w * R + i] - M);
      a += red_acc[(w * R + i) * HD + d] * e;
      L += red_l[w * R + i] * e;
    }
    const int t = gr / r, j = gr % r;
    const long long row = row_base + ((long long)b * Q + t) * Hq + h * r + j;
    a_dst[row * HD + d] = a;
    if (d == 0) {
      m_dst[row] = M * kLn2;
      l_dst[row] = L;
    }
  }
  if (direct) return;

  // the last live split of (b, h, query tile) to get here merges them all
  // (the ring is free)
  paged::merge_live_splits<kThreads, R, HD>(
      reinterpret_cast<float*>(ring), acc_ws, m_ws, l_ws, acc_out, m_out,
      l_out, counters + ((long long)b * Hkv + h) * n_qtiles + qtile, n_live,
      row0, n_rows_total, b, Q, Hq, h, r, R_all);
}

// ---- the prefill entry: tensor cores ----------------------------------------

constexpr int kPfThreads = 128;  // one warpgroup
constexpr int kPfRows = 64;      // grouped query rows per block (wgmma M)
constexpr int kPfKeys = 64;      // keys per ring stage
constexpr int kPfStages = 2;
typedef __nv_bfloat16 bf16;

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
        tc::i8x4_to_bf16x4(raw.x, o[0], o[1]);
        tc::i8x4_to_bf16x4(raw.y, o[2], o[3]);
        tc::i8x4_to_bf16x4(raw.z, o[4], o[5]);
        tc::i8x4_to_bf16x4(raw.w, o[6], o[7]);
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
// With n_splits > 1 the live splits' partials land in the workspace
// buffers ([n_splits, B*Q*Hq, hd] and [n_splits, B*Q*Hq]) and the last
// split of each (row, KV head, query tile) to finish merges them into
// acc/m/l, taking a ticket from `counters` (int32, one per (row, KV head,
// query tile), zero between calls; the merging block resets its own).
// Calls that share `counters` must not run concurrently.  Returns the
// first CUDA error (0 = success).
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* lengths, float* acc,
                        float* m, float* l, float* acc_ws, float* m_ws,
                        float* l_ws, int* counters, int B, int Q, int Hq,
                        int Hkv, int hd, int BS, int MB, int NB, int n_splits,
                        long long sb, long long sh, long long ss,
                        long long ssb, long long ssh, int q_dtype,
                        int pool_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  const int r = Hq / Hkv;
  const int rows = Q * r;
  // query rows per block: the GQA group of one token when it fits (no
  // padding rows at Hq / Hkv = 6), else tiles of 8
  const int R = rows <= 4 ? 4 : (rows <= 6 ? 6 : 8);
  const int n_qtiles = (rows + R - 1) / R;
  const dim3 grid(n_qtiles * n_splits, Hkv, B);
  cudaError_t err = paged::dispatch_types(
      q_dtype, pool_dtype, [&](auto tq, auto tk) {
        using Tq = decltype(tq);
        using Tk = decltype(tk);
        return paged::dispatch_hd(hd, [&](auto hd_c) {
          constexpr int HD = decltype(hd_c)::value;
          auto launch = [&](auto r_c) -> cudaError_t {
            constexpr int RR = decltype(r_c)::value;
            constexpr int smem = DecLayout<Tk, HD, RR>::kBytes;
            auto kernel = paged_decode_kernel<Tq, Tk, HD, RR>;
            // above 48 KB a block's shared memory must be asked for, once
            static const cudaError_t attr = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (attr != cudaSuccess) return attr;
            kernel<<<grid, kThreads, smem, st>>>(
                static_cast<const Tq*>(q), static_cast<const Tk*>(k_pool),
                static_cast<const Tk*>(v_pool), k_scale, v_scale, tables,
                lengths, acc, m, l, acc_ws, m_ws, l_ws, counters, Q, Hq, Hkv,
                BS, MB, NB, n_splits, sb, sh, ss, ssb, ssh, scale_log2);
            return cudaGetLastError();
          };
          if (R == 4) return launch(std::integral_constant<int, 4>{});
          if (R == 6) return launch(std::integral_constant<int, 6>{});
          return launch(std::integral_constant<int, 8>{});
        });
      });
  return static_cast<int>(err);
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
