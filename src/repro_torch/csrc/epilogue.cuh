// The flush epilogue shared by the kernels that flush an output tile, plus
// the small element helpers they have in common.
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

// The widest output tile (columns) a block-sparse kernel takes.
constexpr int kMaxBn = 128;

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

// Output kinds of flush_frags: f32, int8 codes, bf16.
constexpr int kOutF32 = 0;
constexpr int kOutI8 = 1;
constexpr int kOutBF16 = 2;

// Flush a thread's accumulator fragments: for its n8 tile n (at columns
// c0 + 8*STEP*n; skipped where bit STEP*n of `skip` is set), columns c and
// c + 1 (c0 = 2*(lane%4) + 8 * the first tile) of rows row0 and row0 + 8, each
// value through the shared epilogue, the two columns written with one store
// (2 bytes of int8 codes, 4 of bf16 or 8 of f32) where both are in the tile
// and aligned.
template <int OUT, int NTW, int STEP, typename Acc>
__device__ __forceinline__ void flush_frags(const Acc (&acc)[NTW][4], const Epilogue& ep,
                                            void* out, size_t row0, int n_total, int rows_left,
                                            int c0, int bn, unsigned skip) {
  using StoreT = typename std::conditional<OUT == kOutBF16, __nv_bfloat16, int8_t>::type;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int c = c0 + 8 * STEP * n;
    if (c >= bn) break;
    if ((skip >> (STEP * n)) & 1u) continue;
    const bool second = c + 1 < bn;
    float v[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h][0] = flush_epilogue<Acc>(acc[n][2 * h], ep, c);
      v[h][1] = second ? flush_epilogue<Acc>(acc[n][2 * h + 1], ep, c + 1) : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows_left <= 8 * h) break;
      const size_t o = row0 + static_cast<size_t>(8 * h) * n_total + c;
      if (second && o % 2 == 0) {
        if constexpr (OUT == kOutI8) {
          const unsigned short pair = static_cast<unsigned short>(
              static_cast<uint8_t>(static_cast<int8_t>(v[h][0])) |
              (static_cast<uint8_t>(static_cast<int8_t>(v[h][1])) << 8));
          *reinterpret_cast<unsigned short*>(static_cast<int8_t*>(out) + o) = pair;
        } else if constexpr (OUT == kOutBF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(v[h][0], v[h][1]);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v[h][0], v[h][1]);
        }
      } else {
        store_out<StoreT>(out, o, v[h][0], OUT == kOutI8);
        if (second) store_out<StoreT>(out, o + 1, v[h][1], OUT == kOutI8);
      }
    }
  }
}

}  // namespace hapm
