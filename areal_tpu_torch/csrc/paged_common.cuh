// Helpers shared by the paged-attention kernels (paged_attention.cu and
// paged_attention_deep.cu): element loads widened to float32, warp
// reductions, the empty partials of a length-0 row, the fused merge of
// key-split partials by the last split to finish (the decode entry and the
// deep kernel's tensor-core body), and the kernel that merges them in a
// second launch (the prefill entry and the deep kernel's CUDA-core body).
//
// Element types: float, __nv_bfloat16, __half, and int8_t (the storage
// type of an int8 KV pool, dequantized by the caller with its scale right
// after the load).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};
template <>
struct Raw<2> {
  using type = uint16_t;
};

// N contiguous elements at p (aligned to their total size, or to 16 bytes
// when larger) -> float32, in loads of at most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes > 16) {
    load_f32<T, N / 2>(p, out);
    load_f32<T, N / 2>(p + N / 2, out + N / 2);
  } else {
    using R = typename Raw<kBytes>::type;
    const R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Write the empty partials (acc = 0, m = -1e30, l = 0) of a block's R
// grouped query rows [row0, row0 + R) of (row b, KV head h); NT threads.
template <int NT, int HD, int R>
__device__ __forceinline__ void write_empty(float* acc, float* m, float* l,
                                            int row0, int n_rows_total, int Q,
                                            int Hq, int r, int b, int h) {
  for (int idx = threadIdx.x; idx < R * HD; idx += NT) {
    const int i = idx / HD, d = idx % HD, gr = row0 + i;
    if (gr >= n_rows_total) continue;
    const int t = gr / r, j = gr % r;
    const long long row = ((long long)b * Q + t) * Hq + h * r + j;
    acc[row * HD + d] = 0.f;
    if (d == 0) {
      m[row] = kNegInf;
      l[row] = 0.f;
    }
  }
}

// The fused split merge.  Called by every block of (row b, KV head h,
// query tile) that wrote its partials to the workspace (acc_ws [S, R_all,
// HD], m_ws and l_ws [S, R_all], m in natural units) when the row has
// n_live > 1 live splits.  Each takes a ticket from `ticket` (an int32,
// zero between calls); the last live split to get one merges every
// split's partials into acc/m/l in split order, so the result does not
// depend on the order the splits finish in, and resets the ticket.
// `scratch` is 2 * n_live * R floats of free shared memory; NT threads.
template <int NT, int R, int HD>
__device__ __forceinline__ void merge_live_splits(
    float* scratch, const float* acc_ws, const float* m_ws, const float* l_ws,
    float* acc_out, float* m_out, float* l_out, int* ticket, int n_live,
    int row0, int n_rows_total, int b, int Q, int Hq, int h, int r,
    long long R_all) {
  __shared__ int s_last;
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every split's m and l -> shared memory, then each row's maximum, the
  // splits' weights exp(m - M) and the merged l; all loads of the
  // workspace are issued before their first use
  float* wm = scratch;          // [n_live][R]: m, then weight
  float* wl = wm + n_live * R;  // [n_live][R]
  for (int idx = threadIdx.x; idx < n_live * R; idx += NT) {
    const int sp = idx / R, i = idx % R, gr = row0 + i;
    float mv = kNegInf, lv = 0.f;
    if (gr < n_rows_total) {
      const long long row =
          sp * R_all + ((long long)b * Q + gr / r) * Hq + h * r + gr % r;
      mv = __ldcg(m_ws + row);
      lv = __ldcg(l_ws + row);
    }
    wm[idx] = mv;
    wl[idx] = lv;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int i = threadIdx.x, gr = row0 + i;
    float M = kNegInf;
    for (int sp = 0; sp < n_live; ++sp) M = fmaxf(M, wm[sp * R + i]);
    float L = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float e = expf(wm[sp * R + i] - M);
      wm[sp * R + i] = e;
      L += wl[sp * R + i] * e;
    }
    if (gr < n_rows_total) {
      const long long row = ((long long)b * Q + gr / r) * Hq + h * r + gr % r;
      m_out[row] = M;
      l_out[row] = L;
    }
  }
  __syncthreads();
  // acc: each thread sums its R * HD / NT elements over the splits in
  // split order
  constexpr int kPer = (R * HD + NT - 1) / NT;
  float a[kPer];
  long long rows[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    a[e] = 0.f;
    const int idx = threadIdx.x + e * NT, i = idx / HD, gr = row0 + i;
    rows[e] = idx < R * HD && gr < n_rows_total
                  ? (((long long)b * Q + gr / r) * Hq + h * r + gr % r) * HD +
                        idx % HD
                  : -1;
  }
#pragma unroll 4
  for (int sp = 0; sp < n_live; ++sp) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (rows[e] < 0) continue;
      const int i = (threadIdx.x + e * NT) / HD;
      a[e] += __ldcg(acc_ws + sp * R_all * HD + rows[e]) * wm[sp * R + i];
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (rows[e] >= 0) acc_out[rows[e]] = a[e];
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next call
}

// Merge n_splits partials [S, R, hd] / [S, R] into [R, hd] / [R].
__global__ void __launch_bounds__(128)
combine_splits_kernel(const float* __restrict__ acc_s,
                      const float* __restrict__ m_s,
                      const float* __restrict__ l_s, float* __restrict__ acc,
                      float* __restrict__ m, float* __restrict__ l,
                      long long R, int hd, int n_splits) {
  const long long row = blockIdx.x;
  float M = kNegInf;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, m_s[s * R + row]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a += acc_s[(s * R + row) * hd + d] * expf(m_s[s * R + row] - M);
    acc[row * hd + d] = a;
  }
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int s = 0; s < n_splits; ++s)
      L += l_s[s * R + row] * expf(m_s[s * R + row] - M);
    m[row] = M;
    l[row] = L;
  }
}

inline cudaError_t combine_splits(const float* acc_s, const float* m_s,
                                  const float* l_s, float* acc, float* m,
                                  float* l, long long R, int hd, int n_splits,
                                  cudaStream_t stream) {
  combine_splits_kernel<<<static_cast<unsigned>(R), 128, 0, stream>>>(
      acc_s, m_s, l_s, acc, m, l, R, hd, n_splits);
  return cudaGetLastError();
}

// dtype codes of the C interfaces: 0 float32, 1 bfloat16, 2 float16,
// 3 int8 (pools only).  Calls fn(Tq{}, Tk{}) for the (q, pool) pairs the
// kernels take: pool type = q type, or an int8 pool with any q type.
template <typename Fn>
cudaError_t dispatch_types(int q_dtype, int pool_dtype, Fn&& fn) {
  if (pool_dtype == 3) {
    switch (q_dtype) {
      case 0: return fn(float{}, int8_t{});
      case 1: return fn(__nv_bfloat16{}, int8_t{});
      case 2: return fn(__half{}, int8_t{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (pool_dtype != q_dtype) return cudaErrorInvalidValue;
  switch (q_dtype) {
    case 0: return fn(float{}, float{});
    case 1: return fn(__nv_bfloat16{}, __nv_bfloat16{});
    case 2: return fn(__half{}, __half{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Fn>
cudaError_t dispatch_hd(int hd, Fn&& fn) {
  switch (hd) {
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged
