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
// int8 codes (`block_sparse_matmul_imma_kernel`; serving under
// implicit=False: a conv's packed patch rows times its packed weight codes,
// tiles (16, 128) and (8, 128) unpacked, (128, 128) packed). What bounds it:
// bytes (the live patch lanes in, the output tile out: bm rows by bn lanes
// of f32 or int8 codes), once the products are on the tensor cores; a live
// tile's products are at most 2*bm*bk*bn int8 operations, far under 1979
// TOP/s. The CUDA-core kernel it replaces widened every code to int32 in
// shared memory and multiplied all bn output lanes with exact IMADs: on the
// unpacked layouts, whose 12-filter groups fill 12 of a tile's 128 lanes,
// about ten times the products needed, on the unit with the lowest integer
// rate. What the design does:
//   * products on the tensor cores (csrc/mma_s8.cuh): mma.sync m16n8k32 per
//     32-lane K step, m16n8k16 for a 16-lane tail; int32 sums are exact in
//     any order, so the result equals the plain version bit for bit. 8
//     warps, warp w the m16 rows 16w.. of the M-block; rows past bm are
//     zero-filled and not stored, a warp wholly past bm only copies. At
//     most 128 registers, so that two blocks share an SM.
//   * the column's live K-tiles end to end: the block walks the K lanes of
//     its live tiles as one sequence (tile idx[j, s] at lanes s*bk ..) in
//     units of 128 lanes, so tiles of bk = 8 or 24 lanes sit back to back in
//     a K step and nothing is read past a tile; only the last unit's tail is
//     zero-filled up to the step depth. A lane's tile is found by a multiply
//     and a shift (FastDiv), not a division.
//   * only the n8 tiles that hold a nonzero code: a unit's weight rows move
//     as 4x4-byte blocks (cp.async, 4 bytes a row) into a ring slot at a row
//     pitch of 136 words; each thread transposes the blocks it copied in
//     place with byte permutes into B-fragment words (B loads then fall on
//     32 distinct banks) and notes which n8 tiles and which 32-row steps of
//     the unit hold a nonzero code. The products run up to the last such n8
//     tile (2 of 16 on the unpacked layouts) and skip the steps whose weight
//     rows are all zero. An n8 tile with no nonzero code in any unit holds
//     the epilogue of a zero accumulator in every row: the block computes
//     that row once through flush_epilogue and writes it in 16-byte stores.
//   * staging: x rows (K-contiguous: the A operand's layout) and the weight
//     blocks of a unit move through a ring of three cp.async slots, two
//     units in flight while one is multiplied, one barrier per unit. An x
//     row pitch of 144 bytes puts the A-fragment loads on distinct banks
//     (128 would put a warp's rows on four). Operands whose rows or pointers
//     are not 16-byte aligned take the same kernel with 8- or 4-byte
//     copies, or with element copies.
//   * one column a block, and the N-tiles of one M-block next to each other
//     in the grid, as for the f32 instance. A column with cnt == 0 stages
//     nothing and writes the zero-accumulator row. Fixed order, no atomics
//     on data: two launches on the same inputs give the same bits.
//   * the flush runs `flush_frags` (epilogue.cuh) from the C fragments, two
//     adjacent columns a store.
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
#include "mma_s8.cuh"

namespace hapm {

// ---------------------------------------------------------------------------
// int8 codes: tensor cores (mma.sync s8)

constexpr int kImThreads = 256;
constexpr int kImWarps = kImThreads / 32;
constexpr int kImRows = 16 * kImWarps;         // rows of a staged x unit: bm <= 128
constexpr int kImUnit = 128;                   // K lanes of a unit (x lanes, weight rows)
constexpr int kImStages = 3;
constexpr int kImPitchX = kImUnit + 16;        // bytes per staged x row: 36 words
constexpr int kImPitchW = kMaxBn + 8;          // words per weight word row: 8 mod 32
constexpr int kImSlotX = kImRows * kImPitchX;  // bytes
constexpr int kImSlotW = kImUnit / 4 * kImPitchW * 4;
constexpr int kImWBlocks = kImUnit / 4 * (kMaxBn / 4) / kImThreads;  // 4x4 blocks a thread moves
constexpr int kImTiles = kMaxBn / 8;           // n8 tiles of sums a warp keeps
constexpr size_t kImSmemBytes = kImStages * static_cast<size_t>(kImSlotX + kImSlotW);

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (mul = ceil(2^p / d),
// p = 31 + ceil(log2 d)); d = 1 passes n through.
struct FastDiv {
  unsigned d, mul, shr;
};

static FastDiv make_fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    const int p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = static_cast<unsigned>(p - 32);
  }
  return f;
}

__device__ __forceinline__ int fast_div(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct ImGeom {
  int K, N;          // row lengths of x (and the K extent of w) and of w / out
  int bm, bk, bn, max_nnz;
  int n_cols;        // N / bn
  FastDiv by_bk;
};

// Block b: N-tile j = b % n_cols of M-block i = b / n_cols. XV: bytes per x
// copy (16, 8 or 4 through cp.async; 1: element copies); kWVec: the weight
// rows are copied 4 bytes at a time through cp.async (else element copies).
template <int XV, bool kWVec>
__global__ void __launch_bounds__(kImThreads, 2)
block_sparse_matmul_imma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                const int* __restrict__ idx, const int* __restrict__ cnt,
                                Epilogue ep, void* __restrict__ out, int out_int8, ImGeom g) {
  extern __shared__ __align__(16) unsigned char im_smem[];
  __shared__ unsigned s_mask[3];                  // per unit: nonzero n8 tiles (bits 0-15)
                                                  // and 32-row steps (bits 16-19)
  __shared__ __align__(16) float s_z[kMaxBn];     // epilogue of a zero accumulator
  __shared__ __align__(16) int8_t s_z8[kMaxBn];   // the same as int8 codes
  auto xs = [&](int u) { return reinterpret_cast<int8_t*>(im_smem) + (u % kImStages) * kImSlotX; };
  auto ws = [&](int u) {
    return reinterpret_cast<int*>(im_smem + kImStages * kImSlotX + (u % kImStages) * kImSlotW);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // mma groupID
  const int tq = lane & 3;   // mma thread in group
  const int j = blockIdx.x % g.n_cols;
  const int i = blockIdx.x / g.n_cols;
  const int* tiles = idx + static_cast<size_t>(j) * g.max_nnz;
  const int n_lanes = cnt[j] * g.bk;  // the live tiles' K lanes, end to end
  const int n_units = (n_lanes + kImUnit - 1) / kImUnit;
  const size_t col0 = static_cast<size_t>(j) * g.bn;
  const Epilogue epj{ep.scale != nullptr ? ep.scale + col0 : nullptr,
                     ep.bias != nullptr ? ep.bias + col0 : nullptr,
                     ep.out_scale != nullptr ? ep.out_scale + col0 : nullptr, ep.relu};
  // the K index (row of w, column of x) of lane l < n_lanes of the sequence
  auto k_of = [&](int l) {
    const int s = fast_div(l, g.by_bk);
    return __ldg(tiles + s) * g.bk + (l - s * g.bk);
  };

  // x: this thread copies lane xl of every unit, rows xr0 + XRP*p
  constexpr int XC = kImUnit / XV;       // copies per row
  constexpr int XRP = kImThreads / XC;   // rows per pass
  constexpr int XP = kImRows / XRP;
  const int xl = (tid % XC) * XV;
  const int xr0 = tid / XC;
  const int8_t* xrow = x + (static_cast<size_t>(i) * g.bm + xr0) * g.K;
  const size_t xstep = static_cast<size_t>(XRP) * g.K;

  // Unit u into its ring slot: x lanes and weight rows past the sequence,
  // x rows past bm and weight columns past bn are zeros. The weights land as
  // 4x4-byte blocks: block (kw, n/4) at words kw*kImPitchW + n .. + 3, one
  // word per row 4kw + r, columns n .. n+3.
  auto stage = [&](int u) {
    int8_t* xd = xs(u);
    const int lx = u * kImUnit + xl;
    const bool lane_ok = lx < n_lanes;
    const int kx = lane_ok ? k_of(lx) : 0;
#pragma unroll
    for (int p = 0; p < XP; ++p) {
      const int r = xr0 + XRP * p;
      const bool ok = lane_ok && r < g.bm;
      const int8_t* src = ok ? xrow + p * xstep + kx : x;
      int8_t* dst = xd + r * kImPitchX + xl;
      if constexpr (XV == 1) {
        *dst = ok ? *src : 0;
      } else if constexpr (XV == 16) {
        cp_async16_zfill(dst, src, ok ? 16 : 0);
      } else {
        cp_async_zfill<XV>(dst, src, ok ? XV : 0);
      }
    }
    int* wd = ws(u);
    const int n = lane * 4;
#pragma unroll
    for (int q = 0; q < kImWBlocks; ++q) {
      const int kw = warp + kImWarps * q;
      int* dst = wd + kw * kImPitchW + n;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = u * kImUnit + 4 * kw + r;
        const bool row_ok = l < n_lanes;
        const int8_t* src = w + static_cast<size_t>(row_ok ? k_of(l) : 0) * g.N + col0 + n;
        if constexpr (kWVec) {
          const bool ok = row_ok && n < g.bn;
          cp_async_zfill<4>(dst + r, ok ? src : w, ok ? 4 : 0);
        } else {
          int v = 0;
          if (row_ok)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (n + c < g.bn) v |= static_cast<int>(static_cast<uint8_t>(src[c])) << (8 * c);
          dst[r] = v;
        }
      }
    }
  };

  // Transpose this thread's landed blocks of unit u in place into B-fragment
  // words (column n's word holds rows 4kw .. 4kw+3); OR into *mask the n8
  // tiles and the 32-row steps that hold a nonzero code. Only the thread
  // that copied a block reads it, so the copy needs no barrier.
  auto convert = [&](int u, unsigned* mask) {
    int* wd = ws(u);
#pragma unroll
    for (int q = 0; q < kImWBlocks; ++q) {
      int4* p = reinterpret_cast<int4*>(wd + (warp + kImWarps * q) * kImPitchW + lane * 4);
      const int4 v = transpose4x4_s8(*p);
      *p = v;
      // a warp's 32 blocks are one word row (of step q) over all 16 n8 tiles
      const unsigned m =
          __reduce_or_sync(0xffffffffu, (v.x | v.y | v.z | v.w) ? 1u << (lane / 2) : 0u);
      if (lane == 0 && m != 0) atomicOr(mask, m | (1u << (16 + q)));
    }
  };

  int acc[kImTiles][4];
#pragma unroll
  for (int n = 0; n < kImTiles; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0;
  const int R0 = 16 * warp;
  const bool active = R0 < g.bm;  // a warp whose rows are all past bm only copies
  constexpr int R8 = 8 * kImPitchX / 4;  // eight x rows, in words

  // The products of unit u up to its last nonzero n8 tile, over its 32-row
  // steps that hold a nonzero weight code (a 16-row tail as one k16 step).
  auto products = [&](int u, unsigned m) {
    const int depth = (min(kImUnit, n_lanes - u * kImUnit) + 15) / 16 * 16;
    const int n_hi = 32 - __clz(m & 0xffffu);
    const int* xa = reinterpret_cast<const int*>(xs(u) + (R0 + gq) * kImPitchX) + tq;
    const int* wb = ws(u) + tq * kImPitchW + gq;
#pragma unroll
    for (int st = 0; st < kImUnit / 32; ++st) {
      if (32 * st >= depth) break;
      if (!((m >> (16 + st)) & 1u)) continue;
      const int* a = xa + 8 * st;
      const int* b = wb + 8 * st * kImPitchW;
      if (depth - 32 * st >= 32) {
        const int a0 = a[0], a1 = a[R8], a2 = a[4], a3 = a[R8 + 4];
#pragma unroll
        for (int n = 0; n < kImTiles; ++n) {
          if (n >= n_hi) break;
          mma_k32(acc[n], a0, a1, a2, a3, b[8 * n], b[4 * kImPitchW + 8 * n]);
        }
      } else {
        const int a0 = a[0], a1 = a[R8];
#pragma unroll
        for (int n = 0; n < kImTiles; ++n) {
          if (n >= n_hi) break;
          mma_k16(acc[n], a0, a1, b[8 * n]);
        }
      }
    }
  };

  // units 0 .. kImStages-2 are requested now, one cp.async group each
  // (empty past the last unit, so that the group count stays fixed)
#pragma unroll
  for (int u = 0; u < kImStages - 1; ++u) {
    if (u < n_units) stage(u);
    cp_async_commit();
  }
  if (tid < 3) s_mask[tid] = 0;
  for (int c = tid; c < g.bn; c += kImThreads) {
    const float z = flush_epilogue<int>(0, epj, c);
    s_z[c] = z;
    s_z8[c] = out_int8 ? static_cast<int8_t>(z) : 0;
  }
  cp_async_wait<kImStages - 2>();  // this thread's copies of unit 0 have landed
  __syncthreads();
  if (n_units > 0) convert(0, &s_mask[0]);
  __syncthreads();

  unsigned any_n8 = 0;  // n8 tiles whose weights hold a nonzero code in some unit
  for (int u = 0; u < n_units; ++u) {
    // into the slot unit u-1 has left: every warp finished its products
    // before the barrier that ended the last iteration
    if (u + kImStages - 1 < n_units) stage(u + kImStages - 1);
    cp_async_commit();
    // unit u's mask; the one convert(u+2) fills next iteration was last
    // read by products(u-1)
    const unsigned m = s_mask[u % 3];
    if (tid == 0) s_mask[(u + 2) % 3] = 0;
    any_n8 |= m;
    if (active) products(u, m);
    if (u + 1 < n_units) {
      cp_async_wait<kImStages - 2>();  // this thread's copies of unit u+1 have landed
      convert(u + 1, &s_mask[(u + 1) % 3]);
    }
    __syncthreads();
  }

  // flush. The n8 tiles whose weights are zero in every unit hold the
  // zero-accumulator row in every row: where the output rows allow 16-byte
  // stores, the block writes them from s_z / s_z8 (16 codes or 4 floats a
  // store); every other tile goes through the fragments: rows gq and gq + 8,
  // columns 2*tq and 2*tq + 1 of each n8 tile.
  const int n8_count = (g.bn + 7) / 8;
  const unsigned dead = ~any_n8 & ((1u << n8_count) - 1u);
  unsigned skip = 0;
  if (out_int8 ? (g.bn % 16 == 0 && g.N % 16 == 0) : (g.bn % 4 == 0 && g.N % 4 == 0))
    skip = out_int8 ? ((dead & (dead >> 1)) & 0x5555u) * 3u : dead;
  if (skip != 0) {
    const int per = out_int8 ? g.bn / 16 : g.bn / 4;  // 16-byte chunks per row
    for (int e = tid; e < g.bm * per; e += kImThreads) {
      const int r = e / per;
      const int ch = e - r * per;
      if (!((skip >> (out_int8 ? 2 * ch : ch / 2)) & 1u)) continue;
      const size_t o = (static_cast<size_t>(i) * g.bm + r) * g.N + col0;
      if (out_int8) {
        *reinterpret_cast<int4*>(static_cast<int8_t*>(out) + o + 16 * ch) =
            *reinterpret_cast<const int4*>(s_z8 + 16 * ch);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o + 4 * ch) =
            *reinterpret_cast<const float4*>(s_z + 4 * ch);
      }
    }
  }
  if (!active) return;
  const int r = R0 + gq;
  const size_t row0 = (static_cast<size_t>(i) * g.bm + r) * g.N + col0;
  if (out_int8) {
    flush_frags<kOutI8, kImTiles, 1>(acc, epj, out, row0, g.N, g.bm - r, 2 * tq, g.bn, skip);
  } else {
    flush_frags<kOutF32, kImTiles, 1>(acc, epj, out, row0, g.N, g.bm - r, 2 * tq, g.bn, skip);
  }
}

template <int XV, bool kWVec>
static cudaError_t launch_imma_instance(const void* x, const void* w, const int* idx,
                                        const int* cnt, const Epilogue& ep, void* out,
                                        int out_int8, const ImGeom& g, int blocks,
                                        cudaStream_t stream) {
  auto kernel = block_sparse_matmul_imma_kernel<XV, kWVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kImSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kImThreads, kImSmemBytes, stream>>>(static_cast<const int8_t*>(x),
                                                       static_cast<const int8_t*>(w), idx, cnt,
                                                       ep, out, out_int8, g);
  return cudaGetLastError();
}

static cudaError_t launch_imma(const void* x, const void* w, const int* idx, const int* cnt,
                               const Epilogue& ep, void* out, int out_int8, int M, int K, int N,
                               int bm, int bk, int bn, int max_nnz, cudaStream_t stream) {
  // x copies of V bytes stay inside one K-tile and on V-byte addresses when
  // V divides x's address, K and bk
  auto x_vec = [&](int v) {
    return reinterpret_cast<uintptr_t>(x) % v == 0 && K % v == 0 && bk % v == 0;
  };
  const bool w_vec = reinterpret_cast<uintptr_t>(w) % 4 == 0 && N % 4 == 0 && bn % 4 == 0;
  const int xv = !w_vec ? 1 : x_vec(16) ? 16 : x_vec(8) ? 8 : x_vec(4) ? 4 : 1;
  const ImGeom g{K, N, bm, bk, bn, max_nnz, N / bn, make_fast_div(static_cast<unsigned>(bk))};
  const long long blocks = static_cast<long long>(M / bm) * g.n_cols;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int nb = static_cast<int>(blocks);
  switch (xv) {
    case 16:
      return launch_imma_instance<16, true>(x, w, idx, cnt, ep, out, out_int8, g, nb, stream);
    case 8:
      return launch_imma_instance<8, true>(x, w, idx, cnt, ep, out, out_int8, g, nb, stream);
    case 4:
      return launch_imma_instance<4, true>(x, w, idx, cnt, ep, out, out_int8, g, nb, stream);
    default:
      return launch_imma_instance<1, false>(x, w, idx, cnt, ep, out, out_int8, g, nb, stream);
  }
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
// bk reads all). The int8 kernel ignores x_lanes: it reads every lane of
// every live tile, and multiplies only the n8 tiles and 32-row steps whose
// weight codes it found nonzero. Requires M % bm == 0, K % bk == 0,
// N % bn == 0, bm <= 128, bn <= 128. Returns the launch's cudaError_t
// (0 = launched).
extern "C" int hapm_block_sparse_matmul(const void* x, const void* w, const int* idx,
                                        const int* cnt, const float* scale, const float* bias,
                                        const float* out_scale, void* out, int M, int K, int N,
                                        int bm, int bk, int bn, int max_nnz, int dtype, int relu,
                                        int x_lanes, void* stream) {
  using namespace hapm;
  if (bm < 1 || bm > kMmRows || bn < 1 || bn > kMaxBn || bk < 1 || M % bm || K % bk || N % bn ||
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
      err = launch_imma(x, w, idx, cnt, ep, out, out_int8, M, K, N, bm, bk, bn, max_nnz, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
