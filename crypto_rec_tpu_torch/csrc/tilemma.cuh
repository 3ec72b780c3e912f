// Shared pieces of the tensor-core slab kernels (slabtile.cu and
// probetile.cu): cp.async, ldmatrix (plain and .trans), mma.sync m16n8k16
// bf16 with f32 accumulation and m16n8k32 s8 with s32 accumulation, the XOR
// swizzles of a staged bf16 or int8 tile, and the three-term bf16 split of
// an f32 query.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tilemma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// the same four 8x8 matrices, each stored transposed (its rows are the
// fragment's columns)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// int8 x int8 -> int32, exact: the fragments hold 4 int8 elements a
// register where the bf16 ones hold 2, in the same bytes (A: row g, bytes
// 4 tig.. of the k step's first and second 16; B the same with the pair on
// n), so one ldmatrix.x4 (b16) reads either
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of 16-byte chunk c of row r in a [rows][d] bf16 block
// (d >= 64: the 8 rows that one ldmatrix matrix reads at one chunk fall on
// 8 distinct chunks of a 128-byte span)
__device__ __forceinline__ int swz(int r, int c, int d) {
  return r * d + ((c ^ (r & 7)) << 3);
}

// byte offset of 16-byte chunk c of row r in a [rows][d] int8 block, d % 64
// == 0.  A row of d % 128 == 0 holds whole 128-byte lines: as `swz`.  At
// d = 64 and 192 a row ends half way through a line, so rows r and r + 1
// start on the line's two halves and the XOR takes the row pair's index
// into the chunk's low two bits (staying inside the row's group of four):
// either way the 8 rows one ldmatrix matrix reads at one chunk sit on 8
// distinct 16-byte bank groups
__device__ __forceinline__ int swz8(int r, int c, int d) {
  return r * d + ((c ^ (d % 128 ? (r >> 1) & 3 : r & 7)) << 4);
}

// q = hi + mid + lo, each term the bf16 rounding of what the ones before it
// left (split_bf16x3 in ops/kernels/slabscore.py); the terms are returned
// as the floats they equal, exact in bf16
__device__ __forceinline__ void split3(float q, float (&t)[3]) {
  t[0] = __bfloat162float(__float2bfloat16_rn(q));
  const float r = q - t[0];
  t[1] = __bfloat162float(__float2bfloat16_rn(r));
  t[2] = __bfloat162float(__float2bfloat16_rn(r - t[1]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tilemma
