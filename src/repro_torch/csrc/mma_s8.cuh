// Tensor-core fragments for int8 codes: the `mma.sync` s8 x s8 -> s32
// wrappers and the 4x4 byte transpose that turns N-contiguous weight rows
// into B fragments, shared by the kernels that multiply int8 codes on
// Hopper's tensor cores (sm_80+ PTX, built for sm_90a). int32 sums of int8
// products are exact in any order.
//
// Fragment layouts (PTX ISA, mma.m16n8k32 / m16n8k16 .s8; g = lane / 4,
// t = lane % 4; a register holds four K-consecutive codes, the lowest K in
// the lowest byte):
//   k32 A: a0 (row g, k 4t..4t+3), a1 (row g+8, k 4t..), a2 (row g, k 16+4t..),
//          a3 (row g+8, k 16+4t..);  B: b0 (k 4t..4t+3, col g), b1 (k 16+4t.., col g)
//   k16 A: a0 (row g, k 4t..4t+3), a1 (row g+8, k 4t..);  B: b0 (k 4t..4t+3, col g)
//   C (both): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1)
#pragma once

#include <stdint.h>

namespace hapm {

// c += a * b on one m16n8k32 tile
__device__ __forceinline__ void mma_k32(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                        int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a * b on one m16n8k16 tile
__device__ __forceinline__ void mma_k16(int (&c)[4], int a0, int a1, int b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Four 8x8 matrices of 16-bit elements from shared memory (ldmatrix.x4):
// lanes 8i .. 8i+7 give the addresses of rows 0-7 of matrix i, and lane l
// receives in r[i] the word at row l / 4, word l % 4 of matrix i. For int8
// codes this is the k32 A fragment of 16 rows when lane l points at row l % 16,
// bytes 16 * (l / 16) .. of the step.
__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A 4x4 block of int8 codes, 4 rows (K) of 4 column bytes (N) in r.x .. r.w,
// transposed into 4 words of 4 K-consecutive codes, one word per column
// (lowest K in the lowest byte): the B-fragment word of each column.
__device__ __forceinline__ int4 transpose4x4_s8(int4 r) {
  const unsigned lo01 = __byte_perm(r.x, r.y, 0x5140);
  const unsigned lo23 = __byte_perm(r.z, r.w, 0x5140);
  const unsigned hi01 = __byte_perm(r.x, r.y, 0x7362);
  const unsigned hi23 = __byte_perm(r.z, r.w, 0x7362);
  int4 v;
  v.x = __byte_perm(lo01, lo23, 0x5410);
  v.y = __byte_perm(lo01, lo23, 0x7632);
  v.z = __byte_perm(hi01, hi23, 0x5410);
  v.w = __byte_perm(hi01, hi23, 0x7632);
  return v;
}

}  // namespace hapm
