// The flush epilogue shared by both block-sparse kernels, plus the small
// element helpers they have in common.
//
// Counterpart of `flush_epilogue` in the JAX package
// (src/repro/kernels/block_sparse_matmul.py): dequant -> bias -> ReLU ->
// requantize, each step optional, every step a separately rounded f32
// operation. `__fmul_rn` / `__fadd_rn` keep the compiler from contracting
// `acc * scale + bias` into one FMA: a fused multiply-add rounds once where
// the reference rounds twice, differs in the last bit, and flips a
// requantized int8 code on a tie. Rounding to codes is `rintf` (half to
// even), saturation is the symmetric +-127.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hapm {

constexpr float kInt8MaxCode = 127.0f;

// Thread layout of both kernels: 16 x 16 threads per block; thread
// (ty, tx) owns output rows ty + 16*a (a < RM) and columns tx + 16*b
// (b < kColsPerThread) of the (bm <= 128, bn <= 128) output tile.
constexpr int kTx = 16;
constexpr int kTy = 16;
constexpr int kThreads = kTx * kTy;
constexpr int kMaxBn = 128;
constexpr int kColsPerThread = kMaxBn / kTx;

// dtype codes of the C interface
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

// Optional per-column rows of the epilogue; a null pointer switches the
// step off. All rows are f32 of length N (the packed column count).
struct Epilogue {
  const float* scale;      // dequant row:  out = float(acc) * scale[n]
  const float* bias;       // bias row:     out += bias[n]
  const float* out_scale;  // requantize:   out = clip(rint(out * out_scale[n]), +-127)
  int relu;
};

template <typename Acc>
__device__ __forceinline__ float flush_epilogue(Acc acc, const Epilogue& ep, int n) {
  float out = static_cast<float>(acc);  // int32 -> f32 rounds to nearest even
  if (ep.scale != nullptr) out = __fmul_rn(out, ep.scale[n]);
  if (ep.bias != nullptr) out = __fadd_rn(out, ep.bias[n]);
  if (ep.relu) out = out < 0.0f ? 0.0f : out;  // NaN passes through
  if (ep.out_scale != nullptr) {
    out = rintf(__fmul_rn(out, ep.out_scale[n]));
    out = fminf(fmaxf(out, -kInt8MaxCode), kInt8MaxCode);
  }
  return out;
}

// Write one flushed value in the output's type: int8 codes after a
// requantizing epilogue, else the operand's float type (f32 for int8 codes).
template <typename T>
__device__ __forceinline__ void store_out(void* out, size_t o, float v, int out_int8) {
  if (out_int8) {
    reinterpret_cast<int8_t*>(out)[o] = static_cast<int8_t>(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[o] = v;
  }
}

// Operand element -> accumulator type (f32 for float operands, int32 for
// int8 codes).
template <typename Acc>
__device__ __forceinline__ Acc to_acc(float v) { return static_cast<Acc>(v); }
template <typename Acc>
__device__ __forceinline__ Acc to_acc(__nv_bfloat16 v) { return static_cast<Acc>(__bfloat162float(v)); }
template <typename Acc>
__device__ __forceinline__ Acc to_acc(int8_t v) { return static_cast<Acc>(v); }

// acc + a*b: one f32 FMA (full f32, no tensor cores, no TF32), or an exact
// int32 multiply-add.
__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }

// Flush the thread's RM x kColsPerThread accumulators of output tile
// (i, j) through the epilogue into `out` (row-major, n_total columns).
template <typename T, typename Acc, int RM>
__device__ __forceinline__ void flush_tile(const Acc (&acc)[RM][kColsPerThread], const Epilogue& ep,
                                           void* out, int out_int8, int i, int j, int bm, int bn,
                                           int n_total, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int r = ty + kTy * a;
    if (r >= bm) continue;
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) {
      const int c = tx + kTx * b;
      if (c >= bn) continue;
      const int n = j * bn + c;
      const float v = flush_epilogue<Acc>(acc[a][b], ep, n);
      store_out<T>(out, (static_cast<size_t>(i) * bm + r) * n_total + n, v, out_int8);
    }
  }
}

}  // namespace hapm
