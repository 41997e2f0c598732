// Helpers shared by the paged-attention kernels (paged_attention.cu and
// paged_attention_deep.cu): element loads widened to float32, warp
// reductions, and the kernel that merges key-split partials.
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
