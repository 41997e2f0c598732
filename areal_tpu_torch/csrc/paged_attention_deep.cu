// Deep paged flash-attention partials for NVIDIA Hopper (sm_90a): the
// key range streams through a ring of shared-memory stages with several
// tiles in flight.  Also serves flash_decode over a contiguous cache.
//
// Replaces the Pallas TPU kernel `paged_flash_attention_deep`
// (areal_tpu/ops/paged_attention.py:463; body `_deep_kernel` :363, ring
// depth `DEEP_BUFFERS` :360, sized at :501) and, through the
// `flash_decode_fwd` entry point below, `flash_decode`
// (areal_tpu/ops/decode_attention.py:150; body `_kernel` :99, index map
// `_clamped_kv_map` :137).  Same contract as the standard paged kernel
// (paged_attention.cu): every query token of row b attends the row's
// whole cached prefix [0, lengths[b]) through the row's block table, and
// the kernel emits UN-normalised online-softmax partials (acc, m, l) in
// float32; a row with length 0 yields acc = 0, l = 0, m = -1e30 exactly.
//
// Layouts: q [B, Q, Hq, hd]; pools [NB, Hkv, BS, hd] through their
// block/head/slot strides (hd contiguous); an int8 pool comes with float32
// scale pools [NB, Hkv, BS] (block/head strides, slots contiguous);
// tables [B, MB] int32; lengths [B] int32; acc [B, Q, Hq, hd], m and l
// [B, Q, Hq].
//
// What bounds it on an H100: HBM bytes.  At the main path's decode shape
// (16 rows, Q = 1, 12 query heads over Hkv = 2, hd = 128, contexts up to
// 32768 tokens) one layer's call must read up to 537 MB of a bf16 pool
// (0.160 ms at 3.35 TB/s) or 277 MB of an int8 pool with its scales
// (0.083 ms), and does 4 * Q * Hq * hd flops per cached token: far below
// the ops:byte ridge.  The stream needs enough bytes in flight per SM to
// cover the memory latency (3.35 TB/s x ~1 us is ~25 KB per SM), and few
// enough instructions per byte that issue does not bound it: f32 FMAs on
// CUDA cores, ~8 per int8 byte with its conversion and scale, do.
//
// Two bodies, picked from the dtypes alone (`deep_fwd`):
//
// The tensor-core body (bf16 q over a bf16 or an int8 pool: the main path,
// and flash_decode on bf16):
// * A block (4 consumer warps and 1 producer warp) owns (row b, KV head h,
//   tile of kTcRows = 8 grouped query rows, key split): the GQA group of
//   one token (6 rows at Hq / Hkv = 12 / 2) is one tile, so each staged
//   K/V byte serves all of it.
// * 64-key stages of K and V (and an int8 pool's 64 K and 64 V scales)
//   stream through a ring sized by a shared-memory budget (3 stages of 32
//   KB for a bf16 pool at hd = 128, 6 of 16.5 KB for int8; two blocks per
//   SM).  Each stage completes on its own "full" mbarrier and is released
//   by the consumers through an "empty" one.  The rows land in the
//   128-byte swizzle layout (`tile_off`): [128-byte column block][key][128
//   bytes], the 16-byte chunk index XORed with key % 8, so `ldmatrix`
//   reads 8 keys at one column on distinct banks.
// * Copies: when a page holds whole 64-key tiles and a row is a whole
//   number of 128-byte blocks (the main path: pages of 256, hd = 128, and
//   flash_decode's rows), one lane of the producer warp issues TMA box
//   copies (64 keys x 128 bytes of a 4-D tensor map (hd, BS, Hkv, NB) over
//   the layer slice, encoded on the host per call) and 1-D bulk copies of
//   the scales: 2 + 2 (bf16) or 1 + 1 + 2 (int8) copies per stage and one
//   table lookup.  Other shapes (pages of 48, int8 rows of 64 bytes) take
//   per-key 16-byte `cp.async` copies from the producer warp into the same
//   layout, arriving on the same barrier.  The rule is on shapes and
//   strides only, never a reaction to a failure.
// * Products on `mma.sync.m16n8k16` with bf16 operands and f32
//   accumulation, transposed so the 8 grouped rows are the N = 8 side:
//   S^T = K Q^T (K the A operand through `ldmatrix`, Q's B fragments held
//   in registers for the whole loop) and O^T = V^T P^T (V through
//   `ldmatrix.trans`).  `wgmma` would need 64 rows, 10x the live ones.
//   Warp w takes keys [16 w, 16 w + 16) of each stage: 8 products for S^T
//   and 16 for O^T at hd = 128.  bf16 x bf16 products are exact in f32, so
//   the dots keep the reference's f32 precision.
// * int8 K and V are widened to bf16 in registers right after `ldmatrix`,
//   exactly (|v| <= 127; the float-bias trick of the prefill entry), with
//   no work tile: an int8 `ldmatrix` fragment holds 4 consecutive bytes of
//   a key row, so the head-dim axis of the dot is permuted to match (Q's
//   fragments are loaded in that order; a sum does not care), and
//   `ldmatrix.trans` gives 2 keys x 2 dims, so O^T's rows are the permuted
//   dims (undone when the result is written).  An int8 pool's K scale
//   multiplies each key's score after the product, its V scale each key's
//   probability before P V.
// * P V at the reference's precision: P (f32) is split into P_hi =
//   bf16(P) and P_lo = bf16(P - P_hi), and P_hi V + P_lo V accumulate in
//   f32; the score fragment (keys x rows) becomes P^T's B fragment (rows x
//   keys) by `movmatrix.trans`, in registers.
// * Online softmax in f32 in the log2 domain (`ex2.approx` of pre-scaled
//   scores), per warp; m is reported in natural units.  Keys past the
//   length are masked by selection, and in the last tile of a row their V
//   rows are zeroed (bf16: a stale or uninitialised row may hold a NaN,
//   and 0 x NaN is NaN; int8 rows are finite and their scales are masked).
// * Splits come from shapes alone (the wrapper's `n_splits`); the last
//   live split of each (row, KV head, query tile) merges every split's
//   partials in split order by a ticket (`paged::merge_live_splits`, shared
//   with the decode entry), so a call is one launch and repeats bit for
//   bit.  No device value is read on the host and nothing is allocated by
//   length.
//
// The CUDA-core body (float32 and float16 q, over their own pools or int8
// ones), unchanged from the first port:
// * The TPU kernel's ring slot is a whole page of every KV head (128 KiB
//   each for K and V at the main path's shape, 8 slots), which does not
//   fit the 227 KiB of shared memory of a block, and its grid (B, QB)
//   gives 16 blocks at decode for 132 SMs.  Here a block owns one (row b,
//   KV head h, tile of kRows GQA query rows, key split), and a second
//   small kernel (paged_common.cuh) merges the splits.
// * Each block streams its key range through a ring of `nstage` stages of
//   kKeys = 64 keys copied with cp.async: nstage - 1 tiles are in flight
//   while one is computed, 3-8 stages by a shared-memory budget.  Each key
//   row is copied on its own, its page looked up in the block table, so a
//   tile may span pages and the page size is free.
// * Compute: 8 warps, two blocks per SM.  Warp w takes keys [8w, 8w + 8)
//   of a stage; the 4 lanes of a key each sum every 4th 8-element chunk
//   of the head dim.  Each warp keeps private (m, l, acc) online-softmax
//   state in registers, merged once in shared memory at the end.  Scores
//   and softmax are float32 (expf).
//
// flash_decode runs as a pool of B pages of S tokens with the table [[0],
// [1], ...] and the cache's strides: the tensor map (hd, S, Hkv, B).
//
// Plain C interface, bound from Python with ctypes
// (areal_tpu_torch/ops/paged_attention.py, areal_tpu_torch/ops/
// decode_attention.py); no PyTorch headers.  The tensor map's encoder,
// `cuTensorMapEncodeTiled`, is looked up through the runtime
// (`cudaGetDriverEntryPoint`), so nothing links libcuda.

#include <cuda.h>  // CUtensorMap and the encoder's types

#include <string.h>

#include "mma_common.cuh"
#include "paged_common.cuh"

namespace {

using paged::kFull;
using paged::kLn2;
using paged::kNegInf;
using paged::load_f32;
using paged::to_f32;
using paged::warp_max;
typedef __nv_bfloat16 bf16;

// ---- the CUDA-core body (float32 and float16 q) -------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                    // query rows per block
constexpr int kKeys = 64;                   // keys per ring stage
constexpr int kWarpKeys = kKeys / kWarps;   // 8 keys per warp and stage
constexpr int kParts = 32 / kWarpKeys;      // 4 lanes share a key
constexpr int kPad = 16;                    // bytes after each staged row
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kStageBudget = 110 * 1024;    // bytes of ring per block
constexpr int kMaxSmem = 227 * 1024;

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: tc::cp_async_wait<0>(); break;
    case 1: tc::cp_async_wait<1>(); break;
    case 2: tc::cp_async_wait<2>(); break;
    case 3: tc::cp_async_wait<3>(); break;
    case 4: tc::cp_async_wait<4>(); break;
    case 5: tc::cp_async_wait<5>(); break;
    default: tc::cp_async_wait<6>(); break;
  }
}

template <typename Tk, int HD>
struct Layout {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(Tk));
  static constexpr int kRowStride = kRowBytes + kPad;
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte pieces per row
  static constexpr int kKBytes = kKeys * kRowStride;
  // K rows, V rows, K scales, V scales
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kKeys * 4;
  static constexpr int kQBytes = kRows * HD * 4;
  static constexpr int kRedBytes = kWarps * kRows * (HD + 2) * 4;
  static int stages() {
    int n = kStageBudget / kStageBytes;
    return n < kMinStages ? kMinStages : (n > kMaxStages ? kMaxStages : n);
  }
  static int smem_bytes(int nstage) {
    const int ring = nstage * kStageBytes;
    return kQBytes + (ring > kRedBytes ? ring : kRedBytes);
  }
};

template <typename Tq, typename Tk, int HD>
__global__ void __launch_bounds__(kThreads, 2)
paged_deep_kernel(const Tq* __restrict__ q, const Tk* __restrict__ k_pool,
                  const Tk* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int Q,
                  int Hq, int Hkv, int BS, int MB, int NB, int n_splits,
                  long long sb, long long sh, long long ss, long long ssb,
                  long long ssh, int nstage, float scale) {
  using Lay = Layout<Tk, HD>;
  constexpr bool kQuant = std::is_same<Tk, int8_t>::value;
  constexpr int CPL = HD / 32;  // acc columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kRows][HD]
  unsigned char* ring = smem + Lay::kQBytes;

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

  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    float v = 0.f;
    if (gr < n_rows_total) {
      const int t = gr / r, j = gr % r;
      v = to_f32(q[(((long long)b * Q + t) * Hq + h * r + j) * HD + d]);
    }
    q_s[i * HD + d] = v;
  }

  const int length = max(0, min(lengths[b], MB * BS));
  const int n_tiles = (length + kKeys - 1) / kKeys;
  const int per_split = (n_tiles + n_splits - 1) / n_splits;
  const int t_begin = split * per_split;
  const int n = max(0, min(n_tiles, t_begin + per_split) - t_begin);
  const int* table = tables + (long long)b * MB;

  // copy tile `tile`'s valid keys into ring stage `slot`
  auto load_stage = [&](int tile, int slot) {
    unsigned char* st = ring + slot * Lay::kStageBytes;
    const int base = tile * kKeys;
    // unrolled, so the table lookups of all of a thread's rows issue
    // before their copies
#pragma unroll
    for (int idx = threadIdx.x; idx < kKeys * Lay::kChunks;
         idx += kThreads) {
      const int key = idx / Lay::kChunks, c = idx % Lay::kChunks;
      const int pos = base + key;
      if (pos >= length) continue;
      const int page = min(max(table[pos / BS], 0), NB - 1);
      const long long off = page * sb + h * sh + (long long)(pos % BS) * ss;
      const int dst = key * Lay::kRowStride + c * 16;
      tc::cp_async16(st + dst,
                     reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
                     true);
      tc::cp_async16(st + Lay::kKBytes + dst,
                     reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
                     true);
    }
    if constexpr (kQuant) {
      float* ks_s = reinterpret_cast<float*>(st + 2 * Lay::kKBytes);
#pragma unroll
      for (int key = threadIdx.x; key < kKeys; key += kThreads) {
        const int pos = base + key;
        if (pos >= length) continue;
        const int page = min(max(table[pos / BS], 0), NB - 1);
        const long long so = page * ssb + h * ssh + pos % BS;
        tc::cp_async4(ks_s + key, k_scale + so, true);
        tc::cp_async4(ks_s + kKeys + key, v_scale + so, true);
      }
    }
  };

  float m[kRows], l[kRows], acc[kRows][CPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }

  // prologue: tiles 0 .. nstage-2 in flight (one copy group each, empty
  // groups included, so the group count stays uniform)
  for (int s = 0; s < nstage - 1; ++s) {
    if (s < n) load_stage(t_begin + s, s);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait_dyn(nstage - 2);  // this thread's copies of tile i landed
    __syncthreads();  // everyone's did; the stage of tile i-1 is free
    const int nxt = i + nstage - 1;
    if (nxt < n) load_stage(t_begin + nxt, nxt % nstage);
    tc::cp_async_commit();

    const unsigned char* st = ring + (i % nstage) * Lay::kStageBytes;
    const int tile_base = (t_begin + i) * kKeys;
    const int wbase = tile_base + warp * kWarpKeys;  // this warp's first key
    if (wbase < length) {  // warp-uniform: >= 1 valid key in the group
      const int kk = lane % kWarpKeys;
      const int part = lane / kWarpKeys;
      const int key = warp * kWarpKeys + kk;  // key within the stage
      const bool valid = wbase + kk < length;
      const Tk* krow =
          reinterpret_cast<const Tk*>(st + key * Lay::kRowStride);
      const float* ks_s = reinterpret_cast<const float*>(st + 2 * Lay::kKBytes);
      float s[kRows];
#pragma unroll
      for (int i2 = 0; i2 < kRows; ++i2) s[i2] = 0.f;
      if (valid) {
        const float ksc = kQuant ? ks_s[key] : 1.f;
        // a lane's part of the head dim: every kParts-th 8-element chunk,
        // so the lanes of a key read q from different banks
#pragma unroll
        for (int c = part; c < HD / 8; c += kParts) {
          const int d = c * 8;
          float kf[8];
          load_f32<Tk, 8>(krow + d, kf);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] *= ksc;
          }
#pragma unroll
          for (int i2 = 0; i2 < kRows; ++i2) {
            const float4 qa = *reinterpret_cast<const float4*>(&q_s[i2 * HD + d]);
            const float4 qb =
                *reinterpret_cast<const float4*>(&q_s[i2 * HD + d + 4]);
            float a = s[i2];
            a = fmaf(qa.x, kf[0], a); a = fmaf(qa.y, kf[1], a);
            a = fmaf(qa.z, kf[2], a); a = fmaf(qa.w, kf[3], a);
            a = fmaf(qb.x, kf[4], a); a = fmaf(qb.y, kf[5], a);
            a = fmaf(qb.z, kf[6], a); a = fmaf(qb.w, kf[7], a);
            s[i2] = a;
          }
        }
      }
      // online-softmax update over the warp's keys; the kParts lanes of a
      // key (lanes kk, kk + 8, ...) sum their parts of the dot, and sums
      // over keys run over the 8 lanes of one part
      float p[kRows];
#pragma unroll
      for (int i2 = 0; i2 < kRows; ++i2) {
        float dot = s[i2];
#pragma unroll
        for (int o = kWarpKeys; o < 32; o <<= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        const float sv = valid ? dot * scale : kNegInf;
        const float m_new = fmaxf(m[i2], warp_max(sv));
        p[i2] = expf(sv - m_new);
        float ps = p[i2];
#pragma unroll
        for (int o = kWarpKeys / 2; o > 0; o >>= 1)
          ps += __shfl_xor_sync(kFull, ps, o);
        const float alpha = expf(m[i2] - m_new);
        l[i2] = l[i2] * alpha + ps;
        m[i2] = m_new;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i2][c] *= alpha;
      }
      // P.V over the warp's valid keys: every lane reads its CPL columns
      // of each V row; key k's probabilities come from lane k
      const int n_keys = min(kWarpKeys, length - wbase);
      const unsigned char* vst = st + Lay::kKBytes;
      for (int k = 0; k < n_keys; ++k) {
        const int vk = warp * kWarpKeys + k;
        float vf[CPL];
        load_f32<Tk, CPL>(
            reinterpret_cast<const Tk*>(vst + vk * Lay::kRowStride) + lane * CPL,
            vf);
        if constexpr (kQuant) {
          const float vsc = ks_s[kKeys + vk];
#pragma unroll
          for (int c = 0; c < CPL; ++c) vf[c] *= vsc;
        }
#pragma unroll
        for (int i2 = 0; i2 < kRows; ++i2) {
          const float pk = __shfl_sync(kFull, p[i2], k);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[i2][c] = fmaf(pk, vf[c], acc[i2][c]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials merge there

  float* red_m = reinterpret_cast<float*>(ring);  // [kWarps][kRows]
  float* red_l = red_m + kWarps * kRows;          // [kWarps][kRows]
  float* red_acc = red_l + kWarps * kRows;        // [kWarps][kRows][HD]
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (lane == 0) {
      red_m[warp * kRows + i] = m[i];
      red_l[warp * kRows + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      red_acc[(warp * kRows + i) * HD + lane * CPL + c] = acc[i][c];
  }
  __syncthreads();
  const long long R = (long long)B * Q * Hq;  // rows of one split's output
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    if (gr >= n_rows_total) continue;
    float M = red_m[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w * kRows + i]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(red_m[w * kRows + i] - M);
      a += red_acc[(w * kRows + i) * HD + d] * e;
      L += red_l[w * kRows + i] * e;
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


// ---- the tensor-core body (bf16 q over a bf16 or an int8 pool) ----------------

constexpr int kTcWarps = 4;                        // consumer warps
constexpr int kTcThreads = (kTcWarps + 1) * 32;    // + one producer warp
constexpr int kTcRows = 8;                         // grouped query rows (mma N)
constexpr int kTcKeys = 64;                        // keys per ring stage
constexpr int kTcWarpKeys = kTcKeys / kTcWarps;    // 16: one mma M or K
constexpr int kTcBudget = 100 * 1024;              // bytes of ring per block

// Shared-memory plan (byte offsets from a 1024-aligned base): the ring of
// stages (a K tile and a V tile of kBlocks 128-byte column blocks of 64
// keys each), the scales of each stage (int8 pools: 64 K then 64 V), then
// the stages' full and empty mbarriers.  The warps' partials merge in the
// ring at the end.
template <typename Tk, int HD>
struct TcLayout {
  static constexpr bool kQuant = std::is_same<Tk, int8_t>::value;
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(Tk));
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte pieces per row
  static constexpr int kBlocks = (kRowBytes + 127) / 128;
  static constexpr int kBlockBytes = kTcKeys * 128;
  static constexpr int kTile = kBlocks * kBlockBytes;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kScaleStage = kQuant ? 2 * kTcKeys * 4 : 0;
  static constexpr int kFit = kTcBudget / (kStage + kScaleStage);
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  static constexpr int kScaleOff = kStages * kStage;
  static constexpr int kBarOff = kScaleOff + kStages * kScaleStage;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + align
  static constexpr int kTx = kStage + kScaleStage;  // bytes per TMA stage
  static constexpr int kRedBytes = kTcWarps * kTcRows * (HD + 2) * 4;
  static_assert(kRedBytes <= kScaleOff, "the warps' partials fit the ring");
  static_assert(kSmem <= 227 * 1024, "deep stage too large");
};

// Byte offset of byte `byte` of key `key`'s row in a staged tile: the
// 128-byte swizzle layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B (the
// 16-byte chunk index XORed with key % 8, per 128-byte column block of 64
// keys), for bf16 rows the layout `tc::swz_offset` describes.
__device__ __forceinline__ int tile_off(int key, int byte) {
  return (byte >> 7) * (kTcKeys * 128) + key * 128 +
         ((((byte & 127) >> 4) ^ (key & 7)) << 4) + (byte & 15);
}

// One block: (tile of kTcRows grouped query rows, KV split) of (KV head h,
// row b).  The split owns tiles [t_begin, t_begin + n) of the row's live
// keys; the producer warp copies them into the ring (TMA when `use_tma`,
// else per-key cp.async), and consumer warp w computes keys [16 w, 16 w +
// 16) of every stage with its own online-softmax state, merged across the
// warps at the end.  With several live splits the block writes its
// partials to the workspace and the last split to finish merges them.
template <typename Tk, int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
paged_deep_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, int use_tma,
                     const bf16* __restrict__ q, const Tk* __restrict__ k_pool,
                     const Tk* __restrict__ v_pool,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ tables,
                     const int* __restrict__ lengths,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ acc_ws,
                     float* __restrict__ m_ws, float* __restrict__ l_ws,
                     int* __restrict__ counters, int Q, int Hq, int Hkv,
                     int BS, int MB, int NB, int n_splits, long long sb,
                     long long sh, long long ss, long long ssb, long long ssh,
                     float scale_log2) {
  using Lay = TcLayout<Tk, HD>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int S = Lay::kStages;
  constexpr int KS = HD / 16;  // 16-wide head-dim chunks: score k-steps, O^T m-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-aligned base: the swizzle pattern follows absolute address bits
  unsigned char* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  float* scales = reinterpret_cast<float*>(smem + Lay::kScaleOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::kBarOff);
  uint64_t* empty = full + S;

  const int r = Hq / Hkv;
  const int n_qtiles = gridDim.x / n_splits;
  const int qtile = blockIdx.x / n_splits;
  const int split = blockIdx.x % n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows_total = Q * r;
  const int row0 = qtile * kTcRows;
  const long long R_all = (long long)B * Q * Hq;  // rows of one split

  const int length = max(0, min(lengths[b], MB * BS));
  const int n_tiles = (length + kTcKeys - 1) / kTcKeys;
  const int per_split = (n_tiles + n_splits - 1) / n_splits;
  const int n_live = per_split > 0 ? (n_tiles + per_split - 1) / per_split : 0;
  const int t_begin = split * per_split;
  const int n = max(0, min(n_tiles, t_begin + per_split) - t_begin);
  if (n == 0) {  // no live key: split 0 writes a length-0 row's result
    if (n_tiles == 0 && split == 0)
      paged::write_empty<kTcThreads, HD, kTcRows>(acc_out, m_out, l_out, row0,
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // TMA: one arrival with the stage's bytes; cp.async: one per lane
      tc::mbar_init(full + s, use_tma ? 1 : 32);
      tc::mbar_init(empty + s, kTcWarps);
    }
    tc::fence_mbar_init();
  }
  __syncthreads();

  // the consumers' online-softmax state (log2 domain) of rows 2tq and
  // 2tq + 1, and O^T: acc[c] is m-tile c (16 head dims) x the 8 rows
  float m2[2] = {kNegInf, kNegInf}, lp[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[c][x] = 0.f;

  if (warp == kTcWarps) {
    // ---- the producer warp: tile i of the split into stage i % S, once
    // the consumers have released that stage's previous tile
    const int* table = tables + (long long)b * MB;
    auto page_of = [&](int pos) { return min(max(table[pos / BS], 0), NB - 1); };
    if (use_tma) {
      if (lane == 0) {
        for (int i = 0; i < n; ++i) {
          const int s = i % S;
          if (i >= S) tc::mbar_wait(empty + s, ((i / S) - 1) & 1);
          const int pos = (t_begin + i) * kTcKeys;
          const int page = page_of(pos);
          const int slot = pos % BS;
          unsigned char* st = smem + s * Lay::kStage;
          tc::mbar_expect_tx(full + s, Lay::kTx);
#pragma unroll
          for (int c = 0; c < Lay::kBlocks; ++c) {
            const int col = c * (128 / static_cast<int>(sizeof(Tk)));
            tc::tma_load_4d(st + c * Lay::kBlockBytes, &k_map, col, slot, h,
                            page, full + s);
            tc::tma_load_4d(st + Lay::kTile + c * Lay::kBlockBytes, &v_map,
                            col, slot, h, page, full + s);
          }
          if constexpr (kQuant) {
            const long long so = page * ssb + h * ssh + slot;
            float* sc = scales + s * 2 * kTcKeys;
            tc::bulk_load(sc, k_scale + so, kTcKeys * 4, full + s);
            tc::bulk_load(sc + kTcKeys, v_scale + so, kTcKeys * 4, full + s);
          }
        }
      }
    } else {
      // a page holds whole tiles: one table lookup per tile, else per key
      const bool whole = BS % kTcKeys == 0;
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        if (i >= S) tc::mbar_wait(empty + s, ((i / S) - 1) & 1);
        const int base = (t_begin + i) * kTcKeys;
        const int n_valid = min(kTcKeys, length - base);
        unsigned char* st = smem + s * Lay::kStage;
        long long tile_e = 0, tile_s = 0;
        if (whole) {
          const int page = page_of(base);
          tile_e = page * sb + h * sh + (long long)(base % BS) * ss;
          tile_s = page * ssb + h * ssh + base % BS;
        }
        for (int idx = lane; idx < n_valid * Lay::kChunks; idx += 32) {
          const int key = idx / Lay::kChunks, c = idx % Lay::kChunks;
          long long off;
          if (whole) {
            off = tile_e + key * ss;
          } else {
            const int pos = base + key;
            off = page_of(pos) * sb + h * sh + (long long)(pos % BS) * ss;
          }
          const int dst = tile_off(key, c * 16);
          tc::cp_async16(st + dst,
                         reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
                         true);
          tc::cp_async16(st + Lay::kTile + dst,
                         reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
                         true);
        }
        if constexpr (kQuant) {
          float* sc = scales + s * 2 * kTcKeys;
          for (int key = lane; key < n_valid; key += 32) {
            long long so;
            if (whole) {
              so = tile_s + key;
            } else {
              const int pos = base + key;
              so = page_of(pos) * ssb + h * ssh + pos % BS;
            }
            tc::cp_async4(sc + key, k_scale + so, true);
            tc::cp_async4(sc + kTcKeys + key, v_scale + so, true);
          }
        }
        tc::cp_async_mbar_arrive(full + s);
      }
    }
    __syncwarp();
  } else {
    // ---- a consumer warp
    const int g = lane >> 2, tq = lane & 3;
    // Q^T's B fragments, row g of the tile (padding rows are zero): head
    // dims (16c + 2tq, +1) and (16c + 2tq + 8, +9); for an int8 pool the
    // permuted order (16c + 4tq, +1) and (16c + 4tq + 2, +3) that an int8
    // K fragment holds
    uint32_t qf[KS][2];
    {
      const int gr = row0 + g;
      const bool ok = gr < n_rows_total;
      const bf16* qrow =
          q + (ok ? (((long long)b * Q + gr / r) * Hq + h * r + gr % r) * HD : 0);
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        const int d0 = kQuant ? 16 * c + 4 * tq : 16 * c + 2 * tq;
        const int d1 = kQuant ? d0 + 2 : d0 + 8;
        qf[c][0] = ok ? *reinterpret_cast<const uint32_t*>(qrow + d0) : 0u;
        qf[c][1] = ok ? *reinterpret_cast<const uint32_t*>(qrow + d1) : 0u;
      }
    }
    const int k0 = warp * kTcWarpKeys;  // the warp's first key in a stage
    // ldmatrix row addresses: matrices (keys 0-7 | 8-15) x (chunk c | c+1)
    // in the order the A fragments take them
    const int a_key = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_chunk = lane >> 4;
    const int v_key = k0 + (lane & 7) + (lane >> 4) * 8;  // bf16 V^T
    const int v_chunk = (lane >> 3) & 1;
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      tc::mbar_wait(full + s, (i / S) & 1);
      const int n_valid = min(kTcKeys, length - (t_begin + i) * kTcKeys);
      if (k0 < n_valid) {  // warp-uniform: the warp has a live key
        unsigned char* Kt = smem + s * Lay::kStage;
        unsigned char* Vt = Kt + Lay::kTile;
        const float* ksc = scales + s * 2 * kTcKeys;
        const bool partial = k0 + kTcWarpKeys > n_valid;
        if constexpr (!kQuant) {
          if (partial) {  // zero the V rows past the length
            const int nz = k0 + kTcWarpKeys - n_valid;
            for (int idx = lane; idx < nz * Lay::kBlocks * 8; idx += 32) {
              const int key = n_valid + idx / (Lay::kBlocks * 8);
              const int rest = idx % (Lay::kBlocks * 8);
              *reinterpret_cast<uint4*>(Vt + (rest >> 3) * Lay::kBlockBytes +
                                        key * 128 + (rest & 7) * 16) =
                  make_uint4(0u, 0u, 0u, 0u);
            }
            __syncwarp();
          }
        }
        // S^T = K Q^T: sc[0..1] key k0 + g, rows 2tq, 2tq + 1; sc[2..3]
        // key k0 + g + 8
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kQuant) {
#pragma unroll
          for (int c2 = 0; c2 < KS / 2; ++c2) {
            uint32_t x[4], a[4];
            tc::ldmatrix_x4(x, Kt + tile_off(a_key, (2 * c2 + a_chunk) * 16));
            tc::i8x4_to_bf16x4(x[0], a[0], a[2]);
            tc::i8x4_to_bf16x4(x[1], a[1], a[3]);
            tc::mma_16816(sc, a, qf[2 * c2][0], qf[2 * c2][1]);
            tc::i8x4_to_bf16x4(x[2], a[0], a[2]);
            tc::i8x4_to_bf16x4(x[3], a[1], a[3]);
            tc::mma_16816(sc, a, qf[2 * c2 + 1][0], qf[2 * c2 + 1][1]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            uint32_t a[4];
            tc::ldmatrix_x4(a, Kt + tile_off(a_key, (2 * c + a_chunk) * 16));
            tc::mma_16816(sc, a, qf[c][0], qf[c][1]);
          }
        }
        // scale (and K scale), mask past the length, online softmax
        const int ka = k0 + g, kb = ka + 8;
        const bool oka = ka < n_valid, okb = kb < n_valid;
        float fa = scale_log2, fb = scale_log2;
        if constexpr (kQuant) {
          fa = oka ? ksc[ka] * scale_log2 : 0.f;
          fb = okb ? ksc[kb] * scale_log2 : 0.f;
        }
        sc[0] = oka ? sc[0] * fa : kNegInf;
        sc[1] = oka ? sc[1] * fa : kNegInf;
        sc[2] = okb ? sc[2] * fb : kNegInf;
        sc[3] = okb ? sc[3] * fb : kNegInf;
        float p[4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float mx = fmaxf(sc[x], sc[2 + x]);
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
          const float m_new = fmaxf(m2[x], mx);  // finite: a live key
          const float alpha = tc::exp2_approx(m2[x] - m_new);
          p[x] = tc::exp2_approx(sc[x] - m_new);  // 0 past the length
          p[2 + x] = tc::exp2_approx(sc[2 + x] - m_new);
          lp[x] = lp[x] * alpha + p[x] + p[2 + x];  // summed over g at the end
          m2[x] = m_new;
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            acc[c][x] *= alpha;
            acc[c][2 + x] *= alpha;
          }
        }
        if constexpr (kQuant) {
          const float va = oka ? ksc[kTcKeys + ka] : 0.f;
          const float vb = okb ? ksc[kTcKeys + kb] : 0.f;
          p[0] *= va;
          p[1] *= va;
          p[2] *= vb;
          p[3] *= vb;
        }
        // P^T's B fragments: P_hi and P_lo of keys (g | g + 8) x rows (2tq,
        // 2tq + 1), each 8x8 block turned to rows g x keys (2tq, 2tq + 1)
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * y], p[2 * y + 1]);
          const float2 hf = __bfloat1622float2(hi);
          bh[y] = tc::movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hi));
          bl[y] = tc::movmatrix_trans(
              tc::pack_bf16(p[2 * y] - hf.x, p[2 * y + 1] - hf.y));
        }
        // O^T += V^T P^T: m-tile c is head dims [16c, 16c + 16) (int8: row
        // g of the m-tile is dim 16c + 2g, row g + 8 is dim 16c + 2g + 1)
        if constexpr (kQuant) {
#pragma unroll
          for (int c2 = 0; c2 < KS / 2; ++c2) {
            uint32_t y[4], a[4];
            tc::ldmatrix_x4_trans(y, Vt + tile_off(a_key, (2 * c2 + a_chunk) * 16));
            tc::i8x4_to_bf16x4_cross(y[0], a[0], a[1]);
            tc::i8x4_to_bf16x4_cross(y[1], a[2], a[3]);
            tc::mma_16816(acc[2 * c2], a, bh[0], bh[1]);
            tc::mma_16816(acc[2 * c2], a, bl[0], bl[1]);
            tc::i8x4_to_bf16x4_cross(y[2], a[0], a[1]);
            tc::i8x4_to_bf16x4_cross(y[3], a[2], a[3]);
            tc::mma_16816(acc[2 * c2 + 1], a, bh[0], bh[1]);
            tc::mma_16816(acc[2 * c2 + 1], a, bl[0], bl[1]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < KS; ++c) {
            uint32_t a[4];
            tc::ldmatrix_x4_trans(a, Vt + tile_off(v_key, (2 * c + v_chunk) * 16));
            tc::mma_16816(acc[c], a, bh[0], bh[1]);
            tc::mma_16816(acc[c], a, bl[0], bl[1]);
          }
          // the zeroed rows (generic-proxy writes) before the stage's next
          // TMA write
          if (partial) tc::fence_proxy_async();
        }
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(empty + s);  // the stage is free
    }
  }
  __syncthreads();  // every stage consumed: the warps' partials merge in the ring

  float* red_m = reinterpret_cast<float*>(smem);  // [kTcWarps][kTcRows]
  float* red_l = red_m + kTcWarps * kTcRows;      // [kTcWarps][kTcRows]
  float* red_acc = red_l + kTcWarps * kTcRows;    // [kTcWarps][kTcRows][HD]
  if (warp < kTcWarps) {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float lt = lp[x];
      lt += __shfl_xor_sync(kFull, lt, 4);
      lt += __shfl_xor_sync(kFull, lt, 8);
      lt += __shfl_xor_sync(kFull, lt, 16);
      const int row = 2 * tq + x;
      if (g == 0) {
        red_m[warp * kTcRows + row] = m2[x];
        red_l[warp * kTcRows + row] = lt;
      }
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        const int d_lo = kQuant ? 16 * c + 2 * g : 16 * c + g;
        const int d_hi = kQuant ? d_lo + 1 : d_lo + 8;
        red_acc[(warp * kTcRows + row) * HD + d_lo] = acc[c][x];
        red_acc[(warp * kTcRows + row) * HD + d_hi] = acc[c][2 + x];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTcRows * HD; idx += kTcThreads) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    if (gr >= n_rows_total) continue;
    float M = red_m[i];
#pragma unroll
    for (int w = 1; w < kTcWarps; ++w) M = fmaxf(M, red_m[w * kTcRows + i]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float e = tc::exp2_approx(red_m[w * kTcRows + i] - M);
      a += red_acc[(w * kTcRows + i) * HD + d] * e;
      L += red_l[w * kTcRows + i] * e;
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
  paged::merge_live_splits<kTcThreads, kTcRows, HD>(
      reinterpret_cast<float*>(smem), acc_ws, m_ws, l_ws, acc_out, m_out,
      l_out, counters + ((long long)b * Hkv + h) * n_qtiles + qtile, n_live,
      row0, n_rows_total, b, Q, Hq, h, r, R_all);
}

// ---- host side ------------------------------------------------------------------

// cuTensorMapEncodeTiled's type (cuda.h), reached through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The TMA view of a pool layer slice [NB, Hkv, BS, hd] (strides sb, sh, ss
// in elements of `item` bytes): dims (hd, BS, Hkv, NB) innermost first, a
// box of 128 bytes of a row by 64 keys, 128-byte swizzle.
cudaError_t pool_map(CUtensorMap* map, const void* pool, int item, int hd,
                     int BS, int Hkv, int NB, long long sb, long long sh,
                     long long ss) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(BS),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(NB)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * item),
                                 static_cast<cuuint64_t>(sh * item),
                                 static_cast<cuuint64_t>(sb * item)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / item),
                             static_cast<cuuint32_t>(kTcKeys), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, item == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(pool), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether a call's copies go through TMA: a page holds whole 64-key tiles,
// a row is a whole number of 128-byte boxes, and an int8 pool's scale
// tiles are 16-byte aligned for their bulk copies.  Shapes and strides
// only; `deep_copy_route` in ops/paged_attention.py states the same rule.
bool tma_route(int BS, int hd, int item, const float* k_scale,
               const float* v_scale, long long ssb, long long ssh) {
  if (BS % kTcKeys != 0 || (hd * item) % 128 != 0) return false;
  if (k_scale == nullptr) return true;
  return reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v_scale) % 16 == 0 && ssb % 4 == 0 &&
         ssh % 4 == 0;
}

template <typename Tk, int HD>
cudaError_t launch_tc(dim3 grid, cudaStream_t st, const void* q, const void* k_pool, const void* v_pool,
                      const float* k_scale, const float* v_scale,
                      const int* tables, const int* lengths, float* acc,
                      float* m, float* l, float* acc_ws, float* m_ws,
                      float* l_ws, int* counters, int Q, int Hq, int Hkv,
                      int BS, int MB, int NB, int n_splits, long long sb,
                      long long sh, long long ss, long long ssb, long long ssh,
                      float scale_log2) {
  using Lay = TcLayout<Tk, HD>;
  constexpr int item = static_cast<int>(sizeof(Tk));
  CUtensorMap k_map, v_map;
  memset(&k_map, 0, sizeof(k_map));
  memset(&v_map, 0, sizeof(v_map));
  const bool use_tma = tma_route(BS, HD, item, k_scale, v_scale, ssb, ssh);
  if (use_tma) {
    cudaError_t err = pool_map(&k_map, k_pool, item, HD, BS, Hkv, NB, sb, sh, ss);
    if (err == cudaSuccess)
      err = pool_map(&v_map, v_pool, item, HD, BS, Hkv, NB, sb, sh, ss);
    if (err != cudaSuccess) return err;
  }
  auto kernel = paged_deep_tc_kernel<Tk, HD>;
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kTcThreads, Lay::kSmem, st>>>(
      k_map, v_map, use_tma ? 1 : 0, static_cast<const bf16*>(q),
      static_cast<const Tk*>(k_pool), static_cast<const Tk*>(v_pool), k_scale,
      v_scale, tables, lengths, acc, m, l, acc_ws, m_ws, l_ws, counters, Q, Hq,
      Hkv, BS, MB, NB, n_splits, sb, sh, ss, ssb, ssh, scale_log2);
  return cudaGetLastError();
}

// Both bodies behind one C entry: bf16 q (pool bf16 or int8) runs the
// tensor-core body, float32 and float16 q the CUDA-core body.
cudaError_t deep_fwd(const void* q, const void* k_pool, const void* v_pool,
                     const float* k_scale, const float* v_scale,
                     const int* tables, const int* lengths, float* acc,
                     float* m, float* l, float* acc_ws, float* m_ws,
                     float* l_ws, int* counters, int B, int Q, int Hq, int Hkv,
                     int hd, int BS, int MB, int NB, int n_splits, long long sb,
                     long long sh, long long ss, long long ssb, long long ssh,
                     int q_dtype, int pool_dtype, cudaStream_t st) {
  const int r = Hq / Hkv;
  if (q_dtype == 1) {
    if (pool_dtype != 1 && pool_dtype != 3) return cudaErrorInvalidValue;
    const float scale_log2 =
        1.4426950408889634f / sqrtf(static_cast<float>(hd));
    const int n_qtiles = (Q * r + kTcRows - 1) / kTcRows;
    const dim3 grid(n_qtiles * n_splits, Hkv, B);
    auto run = [&](auto tk) {
      using Tk = decltype(tk);
      return paged::dispatch_hd(hd, [&](auto hd_c) -> cudaError_t {
        constexpr int HD = decltype(hd_c)::value;
        return launch_tc<Tk, HD>(grid, st, q, k_pool, v_pool,
                                 k_scale, v_scale, tables, lengths, acc, m, l,
                                 acc_ws, m_ws, l_ws, counters, Q, Hq, Hkv, BS,
                                 MB, NB, n_splits, sb, sh, ss, ssb, ssh,
                                 scale_log2);
      });
    };
    return pool_dtype == 3 ? run(int8_t{}) : run(bf16{});
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  float* a_dst = n_splits > 1 ? acc_ws : acc;
  float* m_dst = n_splits > 1 ? m_ws : m;
  float* l_dst = n_splits > 1 ? l_ws : l;
  const int n_qtiles = (Q * r + kRows - 1) / kRows;
  const dim3 grid(n_qtiles * n_splits, Hkv, B);
  cudaError_t err = paged::dispatch_types(
      q_dtype, pool_dtype, [&](auto tq, auto tk) -> cudaError_t {
        using Tq = decltype(tq);
        using Tk = decltype(tk);
        if constexpr (std::is_same<Tq, bf16>::value) {
          return cudaErrorInvalidValue;  // the tensor-core body's
        } else {
          return paged::dispatch_hd(hd, [&](auto hd_c) -> cudaError_t {
            constexpr int HD = decltype(hd_c)::value;
            using Lay = Layout<Tk, HD>;
            const int nstage = Lay::stages();
            const int smem = Lay::smem_bytes(nstage);
            if (smem > kMaxSmem) return cudaErrorInvalidValue;
            auto kernel = paged_deep_kernel<Tq, Tk, HD>;
            // above 48 KB a block's shared memory must be asked for, once
            static const cudaError_t attr = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (attr != cudaSuccess) return attr;
            kernel<<<grid, kThreads, smem, st>>>(
                static_cast<const Tq*>(q), static_cast<const Tk*>(k_pool),
                static_cast<const Tk*>(v_pool), k_scale, v_scale, tables,
                lengths, a_dst, m_dst, l_dst, Q, Hq, Hkv, BS, MB, NB,
                n_splits, sb, sh, ss, ssb, ssh, nstage, scale);
            return cudaGetLastError();
          });
        }
      });
  if (err != cudaSuccess || n_splits <= 1) return err;
  return paged::combine_splits(acc_ws, m_ws, l_ws, acc, m, l,
                               static_cast<long long>(B) * Q * Hq, hd,
                               n_splits, st);
}

}  // namespace

extern "C" {

// Arguments as paged_attention_fwd (paged_attention.cu): q_dtype 0 =
// float32, 1 = bfloat16, 2 = float16; pool_dtype the same code, or 3 =
// int8 with float32 scale pools.  With n_splits > 1 the partials land in
// the workspace buffers; the tensor-core body (bf16 q) merges them in its
// last live split with a ticket from `counters` (int32, one per (row, KV
// head, query tile of 8 grouped rows), zero between calls; calls that
// share them must not run concurrently), the CUDA-core body in a second
// kernel.  Returns the first CUDA error (0 = success).
int paged_attention_deep_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, float* acc, float* m, float* l, float* acc_ws,
    float* m_ws, float* l_ws, int* counters, int B, int Q, int Hq, int Hkv,
    int hd, int BS, int MB, int NB, int n_splits, long long sb, long long sh,
    long long ss, long long ssb, long long ssh, int q_dtype, int pool_dtype,
    void* stream) {
  return static_cast<int>(deep_fwd(
      q, k_pool, v_pool, k_scale, v_scale, tables, lengths, acc, m, l, acc_ws,
      m_ws, l_ws, counters, B, Q, Hq, Hkv, hd, BS, MB, NB, n_splits, sb, sh,
      ss, ssb, ssh, q_dtype, pool_dtype, static_cast<cudaStream_t>(stream)));
}

// flash_decode over a contiguous head-major cache k/v [B, Hkv, S, hd]
// (strides sb, sh, ss; hd contiguous): q [B, Hq, hd], lengths [B],
// outputs acc [B, Hq, hd], m and l [B, Hq], counters as above.  The cache
// is a pool of B pages of S tokens read through the table `tables` =
// [[0], [1], ...] ([B, 1] int32, made by the caller), so this is the deep
// kernel with one page per row (its tensor map is (hd, S, Hkv, B)): it
// walks only each row's valid keys, whatever S is.
int flash_decode_fwd(const void* q, const void* k, const void* v,
                     const int* tables, const int* lengths, float* acc,
                     float* m, float* l, float* acc_ws, float* m_ws,
                     float* l_ws, int* counters, int B, int Hq, int Hkv,
                     int hd, int S, int n_splits, long long sb, long long sh,
                     long long ss, int dtype, void* stream) {
  return paged_attention_deep_fwd(q, k, v, nullptr, nullptr, tables, lengths,
                                  acc, m, l, acc_ws, m_ws, l_ws, counters, B,
                                  1, Hq, Hkv, hd, S, 1, B, n_splits, sb, sh,
                                  ss, 0, 0, dtype, dtype, stream);
}

const char* paged_attention_deep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
