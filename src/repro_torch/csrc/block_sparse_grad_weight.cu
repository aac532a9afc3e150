// Block-sparse weight gradient for Hopper (sm_90a): the dW half of every
// block-sparse backward.
//
// Replaces the Pallas TPU kernel `block_sparse_grad_weight`
// (src/repro/kernels/block_sparse_matmul.py, body `_grad_w_kernel`):
//
//   dw[l] = x[:, kk[l]-tile]^T @ g[:, nn[l]-tile]        for the L live tiles
//
// a compact (L, bk, bn) f32 stack; the caller scatters it onto the (K, N)
// grid, so dead tiles are never computed and stay exactly zero.
//
// What bounds it on this card: every live tile contracts the whole row
// axis (M = B*ho*wo, up to 131072 at training batch 128) of a narrow x
// column block (bk = 8 or 16 unpacked, 128 packed) against a 128-lane g
// column block. The bytes are the x and g column blocks of the live tiles,
// read once; the operations 2*M*bk*bn per tile at the f32 rate outside the
// tensor cores. With bk = 128 the operations decide, with bk <= 16 the
// bytes (see chip_smoke.py's bound_ms).
//
// What the design does about it (right and simple first; no tensor cores,
// no TMA, no deeper pipeline than the one register-staged slice below):
//   * The TPU grid walks the M row blocks of one tile in order on one core.
//     Here a tile's rows are split into S fixed chunks (S and the chunk
//     length depend only on M and L, chosen by the wrapper), so that L*S
//     blocks fill the card even when L is 1..8 (the packed layout).
//   * Pass 1: one thread block per (live tile l, chunk s) walks its chunk's
//     rows in order, 32 rows at a time staged through shared memory (x's
//     bk columns and g's bn columns of the tile, converted to f32 once),
//     with the (bk, bn) accumulator in registers (plain fmaf, full f32).
//     A slice's loads are issued together into registers, one slice ahead:
//     they are in flight while the block multiplies the slice before.
//     It writes its partial tile to a workspace ws[s, l].
//   * Pass 2: one thread per output element sums the S partials in chunk
//     order. No float atomics anywhere: two launches on the same inputs do
//     the same operations in the same order and give the same bits.
//   * S == 1 skips the workspace: pass 1 writes the result directly.
//   * Rows past M are never read; the staged rows past a chunk's end are
//     zeros and add nothing.
#include "epilogue.cuh"

namespace hapm {

constexpr int kSliceM = 32;  // rows staged per step (the wrapper's chunk unit)

// One 32-row slice's operands of a block, fetched into registers: x's bk
// columns of the tile (kW staged, zeros past bk) and g's bn columns (zeros
// past bn), zeros for rows past the chunk's end. Unrolled, so every load
// of the slice is in flight at once.
template <typename T, int RK>
__device__ __forceinline__ void fetch_slice(float (&xv)[2 * RK], float (&gv)[kSliceM * kMaxBn / kThreads],
                                            const T* __restrict__ x, const T* __restrict__ g,
                                            int m0, int mc, int K, int N, int k0, int n0, int bk,
                                            int bn, int tid) {
  constexpr int kW = kTy * RK;
#pragma unroll
  for (int i = 0; i < 2 * RK; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kW;
    const int c = e % kW;
    xv[i] = (r < mc && c < bk) ? to_acc<float>(x[static_cast<size_t>(m0 + r) * K + k0 + c]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kSliceM * kMaxBn / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kMaxBn;
    const int c = e % kMaxBn;
    gv[i] = (r < mc && c < bn) ? to_acc<float>(g[static_cast<size_t>(m0 + r) * N + n0 + c]) : 0.0f;
  }
}

template <typename T, int RK>
__global__ void __launch_bounds__(kThreads)
grad_weight_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const int* __restrict__ kk, const int* __restrict__ nn,
                           float* __restrict__ dst, int M, int K, int N, int bk, int bn, int L,
                           int chunk) {
  constexpr int kW = kTy * RK;  // staged x columns (bk <= kW)
  static_assert(kSliceM * kW % kThreads == 0 && 2 * RK == kSliceM * kW / kThreads, "x slice");
  static_assert(kSliceM * kMaxBn % kThreads == 0, "g slice");
  __shared__ float xs[kSliceM][kW + 1];
  __shared__ float gs[kSliceM][kMaxBn];

  const int l = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int k0 = kk[l] * bk;
  const int n0 = nn[l] * bn;
  const int m_begin = s * chunk;
  const int m_end = min(M, m_begin + chunk);

  // thread (ty, tx) owns tile rows ty + 16*a and columns tx + 16*b
  float acc[RK][kColsPerThread];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = 0.0f;

  float xv[2 * RK];
  float gv[kSliceM * kMaxBn / kThreads];
  if (m_begin < m_end)
    fetch_slice<T, RK>(xv, gv, x, g, m_begin, min(kSliceM, m_end - m_begin), K, N, k0, n0, bk,
                       bn, tid);
  for (int m0 = m_begin; m0 < m_end; m0 += kSliceM) {
    __syncthreads();  // the previous slice's products are done
#pragma unroll
    for (int i = 0; i < 2 * RK; ++i) {
      const int e = tid + i * kThreads;
      xs[e / kW][e % kW] = xv[i];
    }
#pragma unroll
    for (int i = 0; i < kSliceM * kMaxBn / kThreads; ++i) {
      const int e = tid + i * kThreads;
      gs[e / kMaxBn][e % kMaxBn] = gv[i];
    }
    __syncthreads();
    // the next slice's loads are in flight while this slice is multiplied
    const int m1 = m0 + kSliceM;
    if (m1 < m_end)
      fetch_slice<T, RK>(xv, gv, x, g, m1, min(kSliceM, m_end - m1), K, N, k0, n0, bk, bn, tid);
#pragma unroll 4
    for (int r = 0; r < kSliceM; ++r) {  // rows past the chunk's end hold zeros
      float av[RK], bv[kColsPerThread];
#pragma unroll
      for (int a = 0; a < RK; ++a) av[a] = xs[r][ty + kTy * a];
#pragma unroll
      for (int b = 0; b < kColsPerThread; ++b) bv[b] = gs[r][tx + kTx * b];
#pragma unroll
      for (int a = 0; a < RK; ++a)
#pragma unroll
        for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }

  float* out = dst + (static_cast<size_t>(s) * L + l) * bk * bn;
#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int r = ty + kTy * a;
    if (r >= bk) continue;
#pragma unroll
    for (int b = 0; b < kColsPerThread; ++b) {
      const int c = tx + kTx * b;
      if (c < bn) out[r * bn + c] = acc[a][b];
    }
  }
}

// out[i] = ws[0, i] + ws[1, i] + ... + ws[S-1, i], left to right.
__global__ void grad_weight_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                          int S, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = ws[i];
  for (int s = 1; s < S; ++s) v += ws[static_cast<size_t>(s) * total + i];
  out[i] = v;
}

template <typename T>
static cudaError_t launch(const void* x, const void* g, const int* kk, const int* nn, float* ws,
                          float* out, int M, int K, int N, int bk, int bn, int L, int S, int chunk,
                          cudaStream_t stream) {
  const dim3 grid(L, S);
  const dim3 block(kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  float* dst = S == 1 ? out : ws;
#define HAPM_GW_LAUNCH(RK)                                                   \
  grad_weight_partial_kernel<T, RK><<<grid, block, 0, stream>>>(xt, gt, kk, nn, dst, M, K, N, \
                                                                 bk, bn, L, chunk)
  if (bk <= 16) {
    HAPM_GW_LAUNCH(1);
  } else if (bk <= 32) {
    HAPM_GW_LAUNCH(2);
  } else if (bk <= 64) {
    HAPM_GW_LAUNCH(4);
  } else {
    HAPM_GW_LAUNCH(8);
  }
#undef HAPM_GW_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t total = static_cast<size_t>(L) * bk * bn;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  grad_weight_reduce_kernel<<<blocks, kThreads, 0, stream>>>(ws, out, S, total);
  return cudaGetLastError();
}

}  // namespace hapm

// x (M, K), g (M, N) row-major of `dtype` (f32 or bf16); kk, nn (L,) int32
// live-tile coordinates in any order; ws (S, L, bk, bn) f32 scratch (null
// when S == 1); out (L, bk, bn) f32. Rows are split into S chunks of
// `chunk` rows (a multiple of 32; (S-1)*chunk < M <= S*chunk). Requires
// K % bk == 0, N % bn == 0, bk <= 128, bn <= 128, L >= 1, M >= 1. Returns
// the launches' cudaError_t (0 = launched).
extern "C" int hapm_block_sparse_grad_weight(const void* x, const void* g, const int* kk,
                                             const int* nn, float* ws, float* out, int M, int K,
                                             int N, int bk, int bn, int L, int S, int chunk,
                                             int dtype, void* stream) {
  using namespace hapm;
  if (bk < 1 || bk > kTy * 8 || bn < 1 || bn > kMaxBn || K % bk || N % bn || L < 1 || M < 1 ||
      S < 1 || S > 65535 || chunk < 1 || chunk % kSliceM ||
      static_cast<long long>(S) * chunk < M || static_cast<long long>(S - 1) * chunk >= M ||
      (S > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float>(x, g, kk, nn, ws, out, M, K, N, bk, bn, L, S, chunk, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(x, g, kk, nn, ws, out, M, K, N, bk, bn, L, S, chunk, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
