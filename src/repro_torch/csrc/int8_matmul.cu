// Dense int8 matmul for Hopper (sm_90a): int8 x int8 -> int32 -> f32 dequant.
//
// Replaces the Pallas TPU kernel `int8_matmul`
// (src/repro/kernels/int8_matmul.py, body `_kernel`):
//
//   out[m, n] = float( sum_k x[m, k] * w[k, n] ) * scale[n]
//
// int32 accumulation (exact), one int -> f32 conversion rounding to nearest
// even, one f32 multiply: bit-identical to `int8_matmul_ref`.
//
// What bounds it on this card depends on the shape. A conv's im2col GEMM
// (M in the thousands, K a few hundred, N = the layer's 16-64 channels) is
// bound by bytes: the patch matrix in and the f32 output out outweigh
// 2*M*K*N int8 operations at the tensor cores' rate. A square product of a
// few thousand is bound by operations. Either way the card's int8 rate lives
// in the tensor cores (wgmma / mma.sync), which this kernel does not use yet,
// so it runs far above both bounds.
//
// What the design does (right and simple first; tensor cores, TMA and
// pipelining are later work):
//   * one thread block per (M-tile i, N-tile j) of bm x bn <= 128 x 128
//     outputs. The TPU grid's sequential K axis becomes a loop inside the
//     block with the int32 accumulators in registers (16 x 16 threads, each
//     owning up to 8 rows x 8 columns), so nothing is carried between
//     blocks.
//   * K is walked in 32-deep slices staged through shared memory as 32-bit
//     words of four K-consecutive codes: x rows are K-contiguous already; a
//     w column's four codes lie N bytes apart in the row-major (K, N)
//     operand, so the staging transposes them into one word. Each product
//     step is then one `__dp4a` (four exact int8 products summed into the
//     int32 accumulator). A K tail shorter than a slice is staged as zeros.
//   * the flush is the dequant step of the shared epilogue (epilogue.cuh)
//     with bias, ReLU and requantize off.
#include "epilogue.cuh"

namespace hapm {

constexpr int kI8SliceK = 32;                   // K codes per staged slice
constexpr int kI8SliceWords = kI8SliceK / 4;    // 32-bit words per row/column

// Four int8 codes -> one word, the lowest K in the lowest byte (the order
// __dp4a pairs bytes in).
__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (static_cast<int>(static_cast<uint8_t>(a))) |
         (static_cast<int>(static_cast<uint8_t>(b)) << 8) |
         (static_cast<int>(static_cast<uint8_t>(c)) << 16) |
         (static_cast<int>(static_cast<uint8_t>(d)) << 24);
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epilogue ep,
                   float* __restrict__ out, int K, int N, int bm, int bn) {
  __shared__ int xs[RM * kTy][kI8SliceWords + 1];  // +1: rows on distinct banks
  __shared__ int ws[kI8SliceWords][kMaxBn];

  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int8_t* xb = x + static_cast<size_t>(i) * bm * K;
  const int8_t* wb = w + static_cast<size_t>(j) * bn;

  int acc[RM][kColsPerThread];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = 0;

  for (int k0 = 0; k0 < K; k0 += kI8SliceK) {
    __syncthreads();  // the previous slice's products are done
    for (int e = tid; e < RM * kTy * kI8SliceWords; e += kThreads) {
      const int r = e / kI8SliceWords;
      const int kw = e % kI8SliceWords;
      int8_t c[4] = {0, 0, 0, 0};
      if (r < bm) {
        const int8_t* row = xb + static_cast<size_t>(r) * K;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + 4 * kw + q;
          if (k < K) c[q] = row[k];
        }
      }
      xs[r][kw] = pack4(c[0], c[1], c[2], c[3]);
    }
    for (int e = tid; e < kI8SliceWords * kMaxBn; e += kThreads) {
      const int kw = e / kMaxBn;
      const int n = e % kMaxBn;
      int8_t c[4] = {0, 0, 0, 0};
      if (n < bn) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + 4 * kw + q;
          if (k < K) c[q] = wb[static_cast<size_t>(k) * N + n];
        }
      }
      ws[kw][n] = pack4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kI8SliceWords; ++kw) {
      int av[RM], bv[kColsPerThread];
#pragma unroll
      for (int a = 0; a < RM; ++a) av[a] = xs[ty + kTy * a][kw];
#pragma unroll
      for (int b = 0; b < kColsPerThread; ++b) bv[b] = ws[kw][tx + kTx * b];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = __dp4a(av[a], bv[b], acc[a][b]);
    }
  }
  flush_tile<int8_t, int, RM>(acc, ep, out, /*out_int8=*/0, i, j, bm, bn, N, ty, tx);
}

}  // namespace hapm

// x (M, K), w (K, N) row-major int8 codes; scale an f32 row of length N; out
// (M, N) f32. Requires M % bm == 0, N % bn == 0, 1 <= bm <= 128,
// 1 <= bn <= 128. Returns the launch's cudaError_t (0 = launched).
extern "C" int hapm_int8_matmul(const void* x, const void* w, const float* scale, void* out,
                                int M, int K, int N, int bm, int bn, void* stream) {
  using namespace hapm;
  if (bm < 1 || bm > kTy * 8 || bn < 1 || bn > kMaxBn || M % bm || N % bn || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{scale, nullptr, nullptr, 0};
  const dim3 grid(M / bm, N / bn);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xt = static_cast<const int8_t*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  float* o = static_cast<float*>(out);
#define HAPM_I8MM_LAUNCH(RM) \
  int8_matmul_kernel<RM><<<grid, block, 0, st>>>(xt, wt, ep, o, K, N, bm, bn)
  if (bm <= 16) {
    HAPM_I8MM_LAUNCH(1);
  } else if (bm <= 32) {
    HAPM_I8MM_LAUNCH(2);
  } else if (bm <= 64) {
    HAPM_I8MM_LAUNCH(4);
  } else {
    HAPM_I8MM_LAUNCH(8);
  }
#undef HAPM_I8MM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
