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
// the ops:byte ridge.  A memory-bound stream needs enough bytes in flight
// per SM to cover the memory latency (3.35 TB/s x ~1 us is ~25 KB per SM).
//
// Design (the TPU kernel's contract, not its blocking):
// * The TPU kernel's ring slot is a whole page of every KV head (128 KiB
//   each for K and V at the main path's shape, 8 slots), which does not
//   fit the 227 KiB of shared memory of a block, and its grid (B, QB)
//   gives 16 blocks at decode for 132 SMs.  Here a block owns one (row b,
//   KV head h, tile of kRows GQA query rows, key split), as in the
//   standard kernel, and a second small kernel merges the splits.
// * Each block streams its key range through a ring of `nstage` stages of
//   kKeys = 64 keys (K rows, V rows and, for int8 pools, their K and V
//   scales), copied with cp.async: nstage - 1 tiles are in flight while
//   one is computed.  The ring is sized by a shared-memory budget (3
//   stages of 35 KB for a bf16 pool at hd = 128, so two blocks share an
//   SM; 5 stages for an int8 pool), at most 8 deep as on the TPU.  A row
//   with more tiles than stages wraps the ring.
// * Each key row is copied on its own (16-byte pieces), its page looked
//   up in the block table, so a tile may span pages and the page size is
//   free: flash_decode runs as a pool of B pages of S tokens with the
//   table [[0], [1], ...] and the cache's strides.
// * Compute: 8 warps, two blocks per SM.  Warp w takes keys [8w, 8w + 8)
//   of a stage; the 4 lanes of a key each sum every 4th 8-element chunk
//   of the head dim, combined by two shuffles.  Each warp keeps private
//   (m, l, acc) online-softmax state in registers, merged once in shared
//   memory at the end.  int8 elements are multiplied by their scale right
//   after the load from shared memory, so the dots stay float32 as in the
//   fp path.
// * Staged rows are padded by 16 bytes, so 8 lanes reading 8 rows at one
//   column hit distinct banks; the interleaved chunks put the 4 lanes of
//   a key on different banks of q.
// * Scores and softmax are float32 (expf), as the reference's
//   HIGHEST-precision dots.
//
// Plain C interface, bound from Python with ctypes
// (areal_tpu_torch/ops/paged_attention.py, areal_tpu_torch/ops/
// decode_attention.py); no PyTorch headers.

#include "paged_common.cuh"

namespace {

using paged::kFull;
using paged::kNegInf;
using paged::load_f32;
using paged::to_f32;
using paged::warp_max;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
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
      cp_async16(st + dst, reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16);
      cp_async16(st + Lay::kKBytes + dst,
                 reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16);
    }
    if constexpr (kQuant) {
      float* ks_s = reinterpret_cast<float*>(st + 2 * Lay::kKBytes);
#pragma unroll
      for (int key = threadIdx.x; key < kKeys; key += kThreads) {
        const int pos = base + key;
        if (pos >= length) continue;
        const int page = min(max(table[pos / BS], 0), NB - 1);
        const long long so = page * ssb + h * ssh + pos % BS;
        cp_async4(ks_s + key, k_scale + so);
        cp_async4(ks_s + kKeys + key, v_scale + so);
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
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait_dyn(nstage - 2);  // this thread's copies of tile i landed
    __syncthreads();  // everyone's did; the stage of tile i-1 is free
    const int nxt = i + nstage - 1;
    if (nxt < n) load_stage(t_begin + nxt, nxt % nstage);
    cp_async_commit();

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
  cp_async_wait<0>();
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

}  // namespace

extern "C" {

// Arguments as paged_attention_fwd (paged_attention.cu): q_dtype 0 =
// float32, 1 = bfloat16, 2 = float16; pool_dtype the same code, or 3 =
// int8 with float32 scale pools.  With n_splits > 1 the partials land in
// the workspace buffers and a second kernel merges them.  Returns the
// first CUDA error (0 = success).
int paged_attention_deep_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, float* acc, float* m, float* l, float* acc_ws,
    float* m_ws, float* l_ws, int B, int Q, int Hq, int Hkv, int hd, int BS,
    int MB, int NB, int n_splits, long long sb, long long sh, long long ss,
    long long ssb, long long ssh, int q_dtype, int pool_dtype,
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
              lengths, a_dst, m_dst, l_dst, Q, Hq, Hkv, BS, MB, NB, n_splits,
              sb, sh, ss, ssb, ssh, nstage, scale);
          return cudaGetLastError();
        });
      });
  if (err != cudaSuccess || n_splits <= 1) return static_cast<int>(err);
  return static_cast<int>(paged::combine_splits(
      acc_ws, m_ws, l_ws, acc, m, l, static_cast<long long>(B) * Q * Hq, hd,
      n_splits, st));
}

// flash_decode over a contiguous head-major cache k/v [B, Hkv, S, hd]
// (strides sb, sh, ss; hd contiguous): q [B, Hq, hd], lengths [B],
// outputs acc [B, Hq, hd], m and l [B, Hq].  The cache is a pool of B
// pages of S tokens read through the table `tables` = [[0], [1], ...]
// ([B, 1] int32, made by the caller), so this is the deep kernel with one
// page per row: it walks only each row's valid keys, whatever S is.
int flash_decode_fwd(const void* q, const void* k, const void* v,
                     const int* tables, const int* lengths, float* acc,
                     float* m, float* l, float* acc_ws, float* m_ws,
                     float* l_ws, int B, int Hq, int Hkv, int hd, int S,
                     int n_splits, long long sb, long long sh, long long ss,
                     int dtype, void* stream) {
  return paged_attention_deep_fwd(q, k, v, nullptr, nullptr, tables, lengths,
                                  acc, m, l, acc_ws, m_ws, l_ws, B, 1, Hq,
                                  Hkv, hd, S, 1, B, n_splits, sb, sh, ss, 0,
                                  0, dtype, dtype, stream);
}

const char* paged_attention_deep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
