// Tensor-core fragments for float operands: the 3xTF32 split and `mma.sync`
// wrappers shared by the kernels that multiply f32 or bf16 on Hopper's
// tensor cores (sm_80+ PTX, built for sm_90a).
//
// f32 operands run as 3xTF32: each operand is split into x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away, as
// `cvt.rna` does), and a product is taken as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi on m16n8k8 TF32 tiles, the two small terms first, each K step's
// sum added to the running f32 sum with one rounding. That keeps about 21 of
// f32's 24 mantissa bits of every product (the a_lo*b_lo term and the bits
// past lo are dropped), where one TF32 product keeps 11: TF32 alone misses
// the kernels' 1e-4 bar. bf16 operands run on m16n8k16 bf16 tiles, whose
// products are exact in the f32 accumulator.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16; g =
// lane / 4, t = lane % 4):
//   tf32 A: a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (row g+8, k t+4)
//   tf32 B: b0 (k t, col g), b1 (k t+4, col g)
//   bf16 A: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..2t+1), a2 (row g, k 2t+8..2t+9),
//           a3 (row g+8, k 2t+8..2t+9), the lower K in the low half of a word
//   bf16 B: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   C (both): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1)
#pragma once

#include <stdint.h>

namespace hapm {

// x rounded to TF32 (10 mantissa bits), as an f32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct Tf32Split {
  uint32_t hi, lo;
};

// x = hi + lo + (bits past lo); x - hi is exact in f32
__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

// c += a * b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: a_lo*b_hi and a_hi*b_lo first, then a_hi*b_hi, into
// a zeroed fragment that is then added to c. The tensor cores' f32
// accumulation does not round to nearest (it truncates), which biases a long
// running sum; this way it touches only one K step's partial sums, and the
// running sum takes one round-to-nearest f32 add per step, as an FMA loop's
// would.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], Tf32Split b0,
                                           Tf32Split b1) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, a_lo, b0.hi, b1.hi);
  mma_tf32(t, a_hi, b0.lo, b1.lo);
  mma_tf32(t, a_hi, b0.hi, b1.hi);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = __fadd_rn(c[q], t[q]);
}

// c += a * b on one m16n8k16 bf16 tile (exact products, f32 sums)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 bit patterns in one fragment word, the lower K in the low half
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}

}  // namespace hapm
