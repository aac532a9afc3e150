// Block-sparse matmul for Hopper (sm_90a): the materializing forward and the
// dX of every block-sparse backward.
//
// Replaces the Pallas TPU kernel `block_sparse_matmul`
// (src/repro/kernels/block_sparse_matmul.py:187, body `_kernel`):
//
//   out[i-blk, j-blk] = epilogue( sum_{s < cnt[j]}  x[i-blk, idx[j,s]-tile]
//                                                 @ w[idx[j,s]-tile, j-blk] )
//
// Both instances keep the TPU kernel's contract: one thread block per
// (M-block i, N-tile j); the TPU grid's third, sequential axis becomes a
// loop over the live K-tiles of column j inside the block, with the sum in
// registers, so pruned tiles cost neither loads nor arithmetic and nothing
// is carried between blocks; the block reads cnt[j] and idx[j, s] itself.
// A column with cnt[j] == 0 runs no loop iteration and still flushes the
// epilogue on a zero accumulator (bias, then ReLU), as the dense
// conv(x, 0) + b would. The epilogue is the one in epilogue.cuh.
//
// int8 codes (`block_sparse_matmul_kernel`; serving under implicit=False).
// CUDA cores: each live tile is staged through shared memory in 16-deep K
// slices, converted to int32 and multiplied with exact integer
// multiply-adds, 16 x 16 threads each owning up to 8 x 8 outputs. Bound by
// the bytes it moves (the patch rows in, the flushed tile out), not by
// arithmetic; its redesign is separate work.
//
// f32 and bf16 operands (`block_sparse_matmul_mma_kernel`; on the main path
// the dX of training, dP = g @ Wp^T on the transposed plan at batch 128).
// What bounds it: bytes, and writing dP (M x K x 4 bytes) is most of them.
// The transposed tiles of the unpacked conv layouts are (128, 16) and
// (128, 8): each live tile reduces over 128 lanes of g, of which the layout
// fills 12 (a 12-filter group; the rest are exact zeros), and writes 16 or 8
// lanes. Multiplying all of it, the CUDA-core design did about 85 times the
// needed products (170 on the 1x1 layout); what is needed is a few GFLOP a
// layer, far under the tensor cores' rate. What the design does:
//   * only the lanes that can be nonzero. `x_lanes` (1..bk; bk by default)
//     is the caller's promise that x is zero past that many lanes of every
//     bk-lane K-tile; the trainable conv's bind passes the layout's
//     `output_lanes` (12 unpacked, 120 packed). The block stages and
//     multiplies those lanes of each live x tile, rounded up to the mma
//     depth (8 for TF32, 16 for bf16), and the same rows of the weight tile.
//     Lanes past them are zero-filled and never read from the next tile
//     (bk = 8 and 24 stay right), and weight rows past x_lanes are zeros,
//     so a lane of x read past x_lanes (up to a 16-byte copy unit) adds
//     exact zeros for finite x.
//   * only the output lanes of the tile: ceil(bn / 8) n8 tiles of its own bn
//     lanes (2 at bn = 16, 1 at 8, 16 at 128); none past bn is stored. The
//     narrow instance (bn <= 16) keeps two n8 tiles of sums in registers, so
//     that more blocks share an SM; the wide one (bn <= 128) sixteen.
//   * products on the tensor cores (csrc/mma_f32.cuh): 8 warps, warp w the
//     m16 rows 16w.. of the M-block; rows past bm (bm = 8, 24, 96) are
//     zero-filled and not stored, and a warp wholly past bm only copies. f32
//     runs as 3xTF32 on m16n8k8 tiles, bf16 on m16n8k16 tiles. Every K step
//     is summed into a zeroed fragment and added to the running sum with one
//     round-to-nearest f32 add: chaining the steps through the tensor cores'
//     truncating accumulator put the training gradients past their float64
//     bar in the implicit conv. The n8 tiles of a step run as straight-line
//     code, so that their product chains overlap: tiles 0-1 over both K
//     steps of a chunk (narrow), each group of four n8 tiles (wide).
//   * staging: a tile's lanes move in chunks of 16 (x: the block's 128 rows
//     by 16 lanes; w: 16 rows by the tile's lanes) through a ring of three
//     cp.async slots, one barrier per chunk, two chunks in flight while one
//     is multiplied. Each thread copies one fixed 16-byte column of every
//     chunk, its pointers computed once per block, so the loop adds only the
//     tile's offset. Row pitches of 20 f32 / 24 bf16 elements (x) and 24 /
//     136 (w) put the fragment loads on distinct banks with no transpose.
//     Operands whose rows or pointers are not 16-byte aligned take the same
//     kernel with element copies instead of cp.async.
//   * one column a block, and the N-tiles of one M-block next to each other
//     in the grid: the columns that visit a g tile run together and find it
//     in L2. A bring-up probe that put the M-blocks of one column side by
//     side instead was slower, most of all at the unpacked 16-channel layer
//     with the most rows. A block over several columns would stage a g tile
//     once for all of them; it was not tried.
//   * the flush runs `flush_frags` (epilogue.cuh) from the C fragments, two
//     adjacent columns a store. Fixed order, no atomics: two launches on the
//     same inputs give the same bits.
#include <limits.h>

#include "cp_async.cuh"
#include "epilogue.cuh"
#include "mma_f32.cuh"

namespace hapm {

// ---------------------------------------------------------------------------
// int8 codes: CUDA cores

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

// ---------------------------------------------------------------------------
// f32 / bf16 operands: tensor cores (3xTF32 / bf16 mma.sync)

constexpr int kMmThreads = 256;
constexpr int kMmWarps = kMmThreads / 32;
constexpr int kMmRows = 16 * kMmWarps;  // rows of a staged x chunk: bm <= 128
constexpr int kMmChunk = 16;            // lanes of x, rows of w, in a ring slot
constexpr int kMmStages = 3;

template <typename T>
constexpr int kMmPitchX = sizeof(T) == 4 ? kMmChunk + 4 : kMmChunk + 8;
template <bool kNarrow>
constexpr int kMmCols = kNarrow ? 16 : kMaxBn;  // w lanes a slot holds
template <bool kNarrow>
constexpr int kMmPitchW = kMmCols<kNarrow> + 8;
template <bool kNarrow>
constexpr int kMmTiles = kMmCols<kNarrow> / 8;  // n8 tiles of sums a warp keeps

template <typename T>
constexpr int kMmSlotX = kMmRows * kMmPitchX<T>;
template <bool kNarrow>
constexpr int kMmSlotW = kMmChunk * kMmPitchW<kNarrow>;
template <typename T, bool kNarrow>
constexpr size_t kMmSmemBytes = kMmStages * (kMmSlotX<T> + kMmSlotW<kNarrow>) * sizeof(T);

struct MmGeom {
  int K, N;          // row lengths of x (and the K extent of w) and of w / out
  int bm, bk, bn, max_nnz;
  int n_cols;        // N / bn
  int x_lanes;       // x is zero past these lanes of a K-tile; w rows past them are not read
  int x_read;        // lanes of a K-tile read from x: x_lanes up to a copy unit, <= bk
  int depth;         // x_lanes rounded up to the mma depth: lanes multiplied
  int chunks;        // kMmChunk-lane chunks of a tile: ceil(depth / kMmChunk)
  int nt;            // n8 tiles of the output lanes: ceil(bn / 8)
};

// A thread's part of every chunk copy: one unit column of x's chunk (rows
// xr0 + XRP*p) and one of w's (rows wr0 + WRP*p). Fixed for the block, so the
// chunk loop adds only the tile's offset.
template <typename T, bool kVec, bool kNarrow>
struct MmCopyPlan {
  static constexpr int U = CopyUnit<T, kVec>::elems;
  static constexpr int XUR = kMmChunk / U;             // units per x row
  static constexpr int XRP = kMmThreads / XUR;         // x rows per pass
  static constexpr int XPasses = kMmRows / XRP;
  static constexpr int WUR = kMmCols<kNarrow> / U;     // units per w row
  static constexpr int WRP = kMmThreads / WUR;         // w rows per pass
  static constexpr int WPasses = (kMmChunk + WRP - 1) / WRP;
  static_assert(kMmThreads % XUR == 0 && kMmRows % XRP == 0 && kMmThreads % WUR == 0,
                "copy plan");
  const T* xrow;   // x at this thread's first row of the M-block, at its lane
  const T* wcol;   // w at this thread's column of the N-tile
  size_t xstep;    // x elements from one pass's row to the next
  int xlane, xr0, wc, wr0;

  __device__ __forceinline__ MmCopyPlan(const T* x, const T* w, const MmGeom& g, int i, int j,
                                        int tid) {
    xlane = (tid % XUR) * U;
    xr0 = tid / XUR;
    xrow = x + (static_cast<size_t>(i) * g.bm + xr0) * g.K + xlane;
    xstep = static_cast<size_t>(XRP) * g.K;
    wc = (tid % WUR) * U;
    wr0 = tid / WUR;
    wcol = w + static_cast<size_t>(j) * g.bn + wc;
  }

  // Chunk c (lanes 16c ..) of K-tile t into one ring slot: x's lanes below
  // x_read and rows below bm, w's rows below x_lanes and columns below bn;
  // zeros everywhere else in the slot. `x`, `w` stand in as the (unread)
  // source of a zero fill.
  __device__ __forceinline__ void stage(T* xs, T* ws, const T* x, const T* w, const MmGeom& g,
                                        int t, int c) const {
    const int k0 = c * kMmChunk;
    const size_t xoff = static_cast<size_t>(t) * g.bk + k0;
    const bool lane_ok = k0 + xlane < g.x_read;
#pragma unroll
    for (int p = 0; p < XPasses; ++p) {
      const int r = xr0 + XRP * p;
      const bool ok = lane_ok && r < g.bm;
      copy_unit<T, kVec>(xs + r * kMmPitchX<T> + xlane, ok ? xrow + p * xstep + xoff : x, ok);
    }
    const bool col_ok = wc < g.bn;
#pragma unroll
    for (int p = 0; p < WPasses; ++p) {
      const int r = wr0 + WRP * p;
      if (r >= kMmChunk) break;
      const bool ok = col_ok && k0 + r < g.x_lanes;
      copy_unit<T, kVec>(ws + r * kMmPitchW<kNarrow> + wc,
                         ok ? wcol + (static_cast<size_t>(t) * g.bk + k0 + r) * g.N : w, ok);
    }
  }
};

struct MmAF32 {  // an A fragment split into TF32 halves
  uint32_t hi[4], lo[4];
};
struct MmABF16 {
  uint32_t a[4];
};

// A[r][k] = xs[R0 + r][k0 + k]: rows g, g+8 of the warp's m16 tile at K t, t+4
__device__ __forceinline__ MmAF32 mm_a_frag(const float* xs, int k0, int R0, int lane) {
  constexpr int P = kMmPitchX<float>;
  const float* a = xs + (R0 + lane / 4) * P + k0 + lane % 4;
  const Tf32Split a0 = split_tf32(a[0]), a1 = split_tf32(a[8 * P]);
  const Tf32Split a2 = split_tf32(a[4]), a3 = split_tf32(a[8 * P + 4]);
  return {{a0.hi, a1.hi, a2.hi, a3.hi}, {a0.lo, a1.lo, a2.lo, a3.lo}};
}

// bf16: the chunk's 16 lanes are one K step; two K-adjacent lanes of a row
// are one word, the lower K in the low half
__device__ __forceinline__ MmABF16 mm_a_frag(const __nv_bfloat16* xs, int /*k0*/, int R0,
                                             int lane) {
  constexpr int P = kMmPitchX<__nv_bfloat16>;
  const uint32_t* a = reinterpret_cast<const uint32_t*>(xs + (R0 + lane / 4) * P) + lane % 4;
  constexpr int P8 = 8 * P / 2;  // eight rows, in words
  return {{a[0], a[P8], a[4], a[P8 + 4]}};
}

// acc[n0 .. n0+G-1] += A x (w's n8 tiles n0 ..) over the K step at lane k0,
// as straight-line code: the G product chains overlap. Each chain sums into
// a zeroed fragment that is added to acc with one rounding.
template <int PW, int G, int NT>
__device__ __forceinline__ void mm_group(float (&acc)[NT][4], const MmAF32& a, const float* ws,
                                         int k0, int n0, int lane) {
  const float* b = ws + (k0 + lane % 4) * PW + 8 * n0 + lane / 4;
  Tf32Split b0[G], b1[G];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    b0[n] = split_tf32(b[8 * n]);
    b1[n] = split_tf32(b[8 * n + 4 * PW]);
  }
#pragma unroll
  for (int n = 0; n < G; ++n) mma_3xtf32(acc[n0 + n], a.hi, a.lo, b0[n], b1[n]);
}

template <int PW, int G, int NT>
__device__ __forceinline__ void mm_group(float (&acc)[NT][4], const MmABF16& a,
                                         const __nv_bfloat16* ws, int /*k0*/, int n0, int lane) {
  const uint16_t* b =
      reinterpret_cast<const uint16_t*>(ws) + 2 * (lane % 4) * PW + 8 * n0 + lane / 4;
  float t[G][4];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    const uint16_t* bp = b + 8 * n;
#pragma unroll
    for (int q = 0; q < 4; ++q) t[n][q] = 0.0f;
    mma_bf16(t[n], a.a, pack_bf16(bp[0], bp[PW]), pack_bf16(bp[8 * PW], bp[9 * PW]));
  }
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n0 + n][q] = __fadd_rn(acc[n0 + n][q], t[n][q]);
}

// The products of one staged chunk: f32 `steps` (1 or 2) K steps of 8
// lanes, bf16 one of 16. Narrow: n8 tiles 0 and 1; wide: each group of four
// n8 tiles below nt (a tile of a group past bn holds sums that are not
// stored).
template <bool kNarrow, typename T>
__device__ __forceinline__ void mm_products(float (&acc)[kMmTiles<kNarrow>][4], const T* xs,
                                            const T* ws, int steps, int nt, int R0, int lane) {
  constexpr int PW = kMmPitchW<kNarrow>;
  if constexpr (kNarrow) {
    if (sizeof(T) == 4 && steps == 2) {  // both f32 K steps as one run
      const auto a0 = mm_a_frag(xs, 0, R0, lane);
      const auto a1 = mm_a_frag(xs, 8, R0, lane);
      mm_group<PW, 2>(acc, a0, ws, 0, 0, lane);
      mm_group<PW, 2>(acc, a1, ws, 8, 0, lane);
    } else {  // one f32 K step, or the bf16 one
      mm_group<PW, 2>(acc, mm_a_frag(xs, 0, R0, lane), ws, 0, 0, lane);
    }
  } else {
#pragma unroll
    for (int k = 0; k < (sizeof(T) == 4 ? 2 : 1); ++k) {
      if (k >= steps) break;
      const auto a = mm_a_frag(xs, 8 * k, R0, lane);
#pragma unroll
      for (int n0 = 0; n0 < kMmTiles<kNarrow>; n0 += 4)
        if (n0 < nt) mm_group<PW, 4>(acc, a, ws, 8 * k, n0, lane);
    }
  }
}

// Block b: N-tile j = b % n_cols of M-block i = b / n_cols, so that the
// N-tiles of one M-block run side by side. kNarrow: bn <= 16.
template <typename T, bool kVec, bool kNarrow>
__global__ void __launch_bounds__(kMmThreads, kNarrow ? 4 : 2)
block_sparse_matmul_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               const int* __restrict__ idx, const int* __restrict__ cnt,
                               Epilogue ep, void* __restrict__ out, MmGeom g) {
  extern __shared__ __align__(16) unsigned char mm_smem[];
  T* xring = reinterpret_cast<T*>(mm_smem);
  T* wring = xring + kMmStages * kMmSlotX<T>;
  auto xs = [&](int u) { return xring + (u % kMmStages) * kMmSlotX<T>; };
  auto ws = [&](int u) { return wring + (u % kMmStages) * kMmSlotW<kNarrow>; };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j = blockIdx.x % g.n_cols;
  const int i = blockIdx.x / g.n_cols;
  const int* tiles = idx + static_cast<size_t>(j) * g.max_nnz;
  const int n_units = cnt[j] * g.chunks;  // (live tile, chunk) pairs, in order
  const MmCopyPlan<T, kVec, kNarrow> plan(x, w, g, i, j, tid);
  auto stage = [&](int u) {
    const int s = u / g.chunks;
    plan.stage(xs(u), ws(u), x, w, g, __ldg(tiles + s), u - s * g.chunks);
  };

  // units 0 .. kMmStages-2 are requested now, one cp.async group each
  // (empty past the last unit, so that the group count stays fixed)
#pragma unroll
  for (int u = 0; u < kMmStages - 1; ++u) {
    if (u < n_units) stage(u);
    cp_async_commit();
  }
  constexpr int NT = kMmTiles<kNarrow>;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
  const int R0 = 16 * warp;
  const bool active = R0 < g.bm;  // a warp whose rows are all past bm only copies
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<kMmStages - 2>();  // this thread's copies of unit u have landed
    // unit u is in place; every warp is done with unit u-1, whose slot the
    // next request reuses
    __syncthreads();
    if (u + kMmStages - 1 < n_units) stage(u + kMmStages - 1);
    cp_async_commit();
    if (active) {
      const int c = u % g.chunks;
      const int steps = min(2, (g.depth - c * kMmChunk) / 8);  // f32 K steps in the chunk
      mm_products<kNarrow>(acc, xs(u), ws(u), steps, g.nt, R0, lane);
    }
  }
  if (!active) return;

  const int r = R0 + lane / 4;  // C fragment rows r, r + 8; columns 2*(lane%4) + 8n (+1)
  const size_t col0 = static_cast<size_t>(j) * g.bn;
  const Epilogue epj{ep.scale != nullptr ? ep.scale + col0 : nullptr,
                     ep.bias != nullptr ? ep.bias + col0 : nullptr, nullptr, ep.relu};
  flush_frags<sizeof(T) == 4 ? kOutF32 : kOutBF16, NT, 1>(
      acc, epj, out, (static_cast<size_t>(i) * g.bm + r) * g.N + col0, g.N, g.bm - r,
      2 * (lane % 4), g.bn, 0u);
}

template <typename T, bool kVec, bool kNarrow>
static cudaError_t launch_mma_instance(const void* x, const void* w, const int* idx,
                                       const int* cnt, const Epilogue& ep, void* out,
                                       const MmGeom& g, int blocks, cudaStream_t stream) {
  auto kernel = block_sparse_matmul_mma_kernel<T, kVec, kNarrow>;
  constexpr size_t smem = kMmSmemBytes<T, kNarrow>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kMmThreads, smem, stream>>>(static_cast<const T*>(x),
                                                static_cast<const T*>(w), idx, cnt, ep, out, g);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_mma(const void* x, const void* w, const int* idx, const int* cnt,
                              const Epilogue& ep, void* out, int M, int K, int N, int bm, int bk,
                              int bn, int max_nnz, int x_lanes, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int depth_step = es == 4 ? 8 : 16;  // K of one mma: m16n8k8 tf32, m16n8k16 bf16
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && (K * es) % 16 == 0 &&
                   (N * es) % 16 == 0 && (bk * es) % 16 == 0 && (bn * es) % 16 == 0;
  const int unit = vec ? 16 / es : 1;
  MmGeom g;
  g.K = K;
  g.N = N;
  g.bm = bm;
  g.bk = bk;
  g.bn = bn;
  g.max_nnz = max_nnz;
  g.n_cols = N / bn;
  g.x_lanes = x_lanes;
  g.x_read = min((x_lanes + unit - 1) / unit * unit, bk);
  g.depth = (x_lanes + depth_step - 1) / depth_step * depth_step;
  g.chunks = (g.depth + kMmChunk - 1) / kMmChunk;
  g.nt = (bn + 7) / 8;
  const long long blocks = static_cast<long long>(M / bm) * g.n_cols;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int nb = static_cast<int>(blocks);
  const bool narrow = bn <= 16;
  if (vec)
    return narrow ? launch_mma_instance<T, true, true>(x, w, idx, cnt, ep, out, g, nb, stream)
                  : launch_mma_instance<T, true, false>(x, w, idx, cnt, ep, out, g, nb, stream);
  return narrow ? launch_mma_instance<T, false, true>(x, w, idx, cnt, ep, out, g, nb, stream)
                : launch_mma_instance<T, false, false>(x, w, idx, cnt, ep, out, g, nb, stream);
}

}  // namespace hapm

// x (M, K), w (K, N) row-major of `dtype`; idx (N/bn, max_nnz), cnt (N/bn)
// int32; scale / bias / out_scale f32 rows of length N or null; out (M, N)
// in the operand's float type (f32 for int8 codes), or int8 codes when
// out_scale is given. x is zero past `x_lanes` (1..bk) lanes of every bk-lane
// K-tile: the f32 / bf16 kernel reads and multiplies none of them (x_lanes =
// bk reads all; int8 codes always read all). Requires M % bm == 0,
// K % bk == 0, N % bn == 0, bm <= 128, bn <= 128. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int hapm_block_sparse_matmul(const void* x, const void* w, const int* idx,
                                        const int* cnt, const float* scale, const float* bias,
                                        const float* out_scale, void* out, int M, int K, int N,
                                        int bm, int bk, int bn, int max_nnz, int dtype, int relu,
                                        int x_lanes, void* stream) {
  using namespace hapm;
  if (bm < 1 || bm > kTy * 8 || bn < 1 || bn > kMaxBn || bk < 1 || M % bm || K % bk || N % bn ||
      x_lanes < 1 || x_lanes > bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{scale, bias, out_scale, relu};
  const int out_int8 = (dtype == kI8 && out_scale != nullptr) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch_mma<float>(x, w, idx, cnt, ep, out, M, K, N, bm, bk, bn, max_nnz, x_lanes, st);
      break;
    case kBF16:
      err = launch_mma<__nv_bfloat16>(x, w, idx, cnt, ep, out, M, K, N, bm, bk, bn, max_nnz,
                                      x_lanes, st);
      break;
    case kI8:
      err = launch<int8_t, int>(x, w, idx, cnt, ep, out, out_int8, M, K, N, bm, bk, bn, max_nnz, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
