// Tensor-core and async-copy helpers shared by the kernels that multiply
// bf16 tiles on Hopper's tensor cores (flash_attention.cu, the prefill
// entry of paged_attention.cu and the tensor-core body of
// paged_attention_deep.cu): warpgroup `wgmma` and warp `mma.sync` products
// with f32 accumulation, `ldmatrix`/`movmatrix` fragment moves, exact int8
// -> bf16 widening, `cp.async` copies with zero fill, and TMA tensor and
// bulk copies that complete on `mbarrier`s.
//
// Register fragments (PTX ISA, the m16n8k16 .bf16 layouts that wgmma's
// register operands and accumulators follow per warp): lane = 4 g + tq
// holds A[g][2tq..2tq+1], A[g+8][..], A[g][2tq+8..], A[g+8][2tq+8..] of a
// 16x16 A tile, and C[g][2tq..2tq+1], C[g+8][2tq..2tq+1] of each 16x8
// block of the accumulator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four int8 values (a 32-bit word, lowest byte first) -> float32, exactly:
// e + 128 goes into the low mantissa byte of the float 2^23, and
// subtracting 2^23 + 128 leaves e.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias;
}

// Four int8 values -> bf16 pairs (e0, e1) and (e2, e3), exactly (|e| <=
// 128 fits bf16's 8-bit significand).
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  float f[4];
  i8x4_to_f32(w, f);
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// Four int8 values -> bf16 pairs (e0, e2) and (e1, e3), exactly: the word
// `ldmatrix.trans` gives from int8 rows holds two bytes of each of two
// rows, and a pair takes one byte of each.
__device__ __forceinline__ void i8x4_to_bf16x4_cross(uint32_t w, uint32_t& lo,
                                                     uint32_t& hi) {
  float f[4];
  i8x4_to_f32(w, f);
  lo = pack_bf16(f[0], f[2]);
  hi = pack_bf16(f[1], f[3]);
}

// 16 bytes global -> shared; with `valid` false the 16 bytes are zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zeroed when not `valid`.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- wgmma (sm_90a) ----------------------------------------------------------
//
// A warpgroup (the 4 warps of a 128-thread block) multiplies a 64-row
// tile: warp w owns rows 16w..16w+15, its accumulator fragment per 8
// columns is the C layout above, and an A operand held in
// registers is the A fragment above, of the warp's 16 rows.  Shared
// operands are read through matrix descriptors over tiles stored in the
// 128-byte swizzle layout of `swz_offset`.  wgmma runs asynchronously:
// issue, `wg_commit`, `wg_wait<0>`, then `wg_fence_acc` on the
// accumulators before they are read, and no A register may change before
// the wait.

// Byte offset of element (row, col) of a bf16 tile of `rows` rows stored
// as [cols / 64][rows][64] with 128-byte swizzle: the 16-byte chunk index
// (col % 64) / 8 is XORed with row % 8.  Tiles start 1024-byte aligned.
__device__ __forceinline__ int swz_offset(int rows, int row, int col) {
  return (col >> 6) * rows * 128 + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets.  For a K-major operand (K = the
// tile's columns) the stride offset is the 1024 bytes between 8-row
// groups (the leading offset is unused) and the start advances by 32
// bytes per k16 step inside a 64-column block.  For an MN-major operand
// (K = the tile's rows) the leading offset is the stride between 64-column
// blocks (rows * 128 bytes) and the stride offset the 1024 bytes between
// 8-row groups.
__device__ __forceinline__ uint64_t wg_desc(const void* smem, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Order the accumulator registers after the wait (and before the next
// issue) for the compiler.
template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Make this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) visible to wgmma's reads; then a block barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 64] += A B^T: A [64 x 16] and B [64 x 16] both K-major in shared
// memory (descriptors da, db).
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A B: A [64 x 16] in registers, B [16 x 64] MN-major in
// shared memory (db).
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32], const uint32_t (&a)[4],
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A B: as wgmma_64x64_rs with B [16 x 128].
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64], const uint32_t (&a)[4],
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x N] += A B for N = 64 or 128 (A in registers, B MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 128)
    wgmma_64x128_rs(d, a, db);
  else
    wgmma_64x64_rs(d, a, db);
}

// ---- warp-level tensor-core products (mma.sync) -----------------------------
//
// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 accumulation; the
// fragments are the m16n8k16 layouts at the top of this file (B: lane 4 g
// + tq holds B[2tq..2tq+1][g] and B[2tq+8..2tq+9][g]).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lanes 8j..8j+7 give the row
// addresses (16 bytes each) of matrix j, and r[j] is lane 4 g + tq's
// fragment of it: row g, elements 2tq and 2tq+1 (with `.trans`, of the
// transposed matrix).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The transpose of an 8x8 b16 matrix held as a fragment (row g, elements
// 2tq..2tq+1 in lane 4 g + tq), as the same kind of fragment.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// ---- mbarriers, TMA and bulk copies -------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once and expect `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// An arrival on the barrier when this thread's earlier cp.async copies
// have landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One box of a 4-D tensor map (a __grid_constant__ kernel parameter) at
// coordinates (c0, c1, c2, c3), innermost first, into shared memory;
// completes on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0,
                                            int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) global -> shared, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace tc
