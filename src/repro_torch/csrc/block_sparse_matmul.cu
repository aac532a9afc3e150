// Block-sparse matmul for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel `block_sparse_matmul`
// (src/repro/kernels/block_sparse_matmul.py, body `_kernel`):
//
//   out[i-blk, j-blk] = epilogue( sum_{s < cnt[j]}  x[i-blk, idx[j,s]-tile]
//                                                 @ w[idx[j,s]-tile, j-blk] )
//
// What bounds it on this card: the tiles are small and mostly padding
// ((16,128) or (8,128) unpacked conv tiles carry 9 x 12 real weights), so
// the work per byte is low and the kernel is bound by the bytes it moves —
// the patch-matrix rows in, the flushed tile out — not by arithmetic.
//
// What the design does about it (right and simple first; tensor cores,
// TMA and pipelining are not used yet):
//   * one thread block per (M-block i, N-tile j). The TPU grid's third,
//     sequential axis becomes a loop over the live K-tiles of column j
//     inside the block, with the accumulator in registers, so pruned tiles
//     cost neither loads nor arithmetic and nothing is carried between
//     blocks. The block reads cnt[j] and idx[j, s] itself.
//   * a column with cnt[j] == 0 runs no loop iteration and still flushes the
//     epilogue on a zero accumulator (bias, then ReLU), as the dense
//     conv(x, 0) + b would.
//   * each live tile is staged through shared memory in 16-deep K slices
//     (static shared memory, well under 48 KB), converted once to the
//     accumulator type: f32 for f32/bf16 operands (plain fmaf, full f32),
//     int32 for int8 codes (exact integer multiply-adds).
//   * the epilogue is the one in epilogue.cuh, shared with the implicit
//     conv kernel.
#include "epilogue.cuh"

namespace hapm {

constexpr int kSliceK = 16;

template <typename T, typename Acc, int RM>
__global__ void __launch_bounds__(kThreads)
block_sparse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const int* __restrict__ idx, const int* __restrict__ cnt, Epilogue ep,
                           void* __restrict__ out, int out_int8, int K, int N, int bm, int bk,
                           int bn, int max_nnz) {
  __shared__ Acc xs[RM * kTy][kSliceK + 1];
  __shared__ Acc ws[kSliceK][kMaxBn];

  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;

  Acc acc[RM][kColsPerThread];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = 0;

  const int live = cnt[j];
  for (int s = 0; s < live; ++s) {
    const int t = idx[j * max_nnz + s];
    for (int k0 = 0; k0 < bk; k0 += kSliceK) {
      const int kc = min(kSliceK, bk - k0);
      __syncthreads();  // the previous slice's products are done
      for (int e = tid; e < RM * kTy * kSliceK; e += kThreads) {
        const int r = e / kSliceK;
        const int k = e % kSliceK;
        Acc v = 0;
        if (r < bm && k < kc)
          v = to_acc<Acc>(x[(static_cast<size_t>(i) * bm + r) * K + t * bk + k0 + k]);
        xs[r][k] = v;
      }
      for (int e = tid; e < kSliceK * kMaxBn; e += kThreads) {
        const int k = e / kMaxBn;
        const int c = e % kMaxBn;
        Acc v = 0;
        if (k < kc && c < bn)
          v = to_acc<Acc>(w[(static_cast<size_t>(t) * bk + k0 + k) * N + j * bn + c]);
        ws[k][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSliceK; ++k) {  // rows past kc hold zeros
        Acc av[RM], bv[kColsPerThread];
#pragma unroll
        for (int a = 0; a < RM; ++a) av[a] = xs[ty + kTy * a][k];
#pragma unroll
        for (int b = 0; b < kColsPerThread; ++b) bv[b] = ws[k][tx + kTx * b];
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
          for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = mac(av[a], bv[b], acc[a][b]);
      }
    }
  }
  flush_tile<T, Acc, RM>(acc, ep, out, out_int8, i, j, bm, bn, N, ty, tx);
}

template <typename T, typename Acc>
static cudaError_t launch(const void* x, const void* w, const int* idx, const int* cnt,
                          const Epilogue& ep, void* out, int out_int8, int M, int K, int N, int bm,
                          int bk, int bn, int max_nnz, cudaStream_t stream) {
  const dim3 grid(M / bm, N / bn);
  const dim3 block(kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
#define HAPM_BSM_LAUNCH(RM)                                                               \
  block_sparse_matmul_kernel<T, Acc, RM><<<grid, block, 0, stream>>>(                     \
      xt, wt, idx, cnt, ep, out, out_int8, K, N, bm, bk, bn, max_nnz)
  if (bm <= 16) {
    HAPM_BSM_LAUNCH(1);
  } else if (bm <= 32) {
    HAPM_BSM_LAUNCH(2);
  } else if (bm <= 64) {
    HAPM_BSM_LAUNCH(4);
  } else {
    HAPM_BSM_LAUNCH(8);
  }
#undef HAPM_BSM_LAUNCH
  return cudaGetLastError();
}

}  // namespace hapm

// x (M, K), w (K, N) row-major of `dtype`; idx (N/bn, max_nnz), cnt (N/bn)
// int32; scale / bias / out_scale f32 rows of length N or null; out (M, N)
// in the operand's float type (f32 for int8 codes), or int8 codes when
// out_scale is given. Requires M % bm == 0, K % bk == 0, N % bn == 0,
// bm <= 128, bn <= 128. Returns the launch's cudaError_t (0 = launched).
extern "C" int hapm_block_sparse_matmul(const void* x, const void* w, const int* idx,
                                        const int* cnt, const float* scale, const float* bias,
                                        const float* out_scale, void* out, int M, int K, int N,
                                        int bm, int bk, int bn, int max_nnz, int dtype, int relu,
                                        void* stream) {
  using namespace hapm;
  if (bm < 1 || bm > kTy * 8 || bn < 1 || bn > kMaxBn || bk < 1 || M % bm || K % bk || N % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{scale, bias, out_scale, relu};
  const int out_int8 = (dtype == kI8 && out_scale != nullptr) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float, float>(x, w, idx, cnt, ep, out, out_int8, M, K, N, bm, bk, bn, max_nnz, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16, float>(x, w, idx, cnt, ep, out, out_int8, M, K, N, bm, bk, bn,
                                         max_nnz, st);
      break;
    case kI8:
      err = launch<int8_t, int>(x, w, idx, cnt, ep, out, out_int8, M, K, N, bm, bk, bn, max_nnz, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
