// Dense int8 matmul for Hopper (sm_90a): int8 x int8 -> int32 -> f32 dequant.
//
// Replaces the Pallas TPU kernel `int8_matmul`
// (src/repro/kernels/int8_matmul.py:72, body `_kernel`):
//
//   out[m, n] = float( sum_k x[m, k] * w[k, n] ) * scale[n]
//
// int32 sums (exact in any order), one int -> f32 conversion rounding to
// nearest even, one f32 multiply: bit-identical to `int8_matmul_ref`.
//
// What bounds it on this card depends on the shape. The im2col GEMM that
// `fixed_point_matmul` runs for the widest conv at batch 128 (8192 x 640 x
// 128) is bound by bytes: 5.2 MB of x in and 4.2 MB of f32 out take 2.8 us at
// 3.35 TB/s, its 1.3 G int8 operations 0.7 us at the tensor cores' 1979
// TOP/s. There a block's chain of phases (copies in, products, flush) sets
// the time, so the card has to be full of blocks with copies in flight. A
// square product of 4096 is bound by operations (0.07 ms); there the
// products and the shared-memory loads that feed them set the time. What the
// design does:
//   * products on the tensor cores (csrc/mma_s8.cuh): mma.sync m16n8k32 per
//     32-deep K step, m16n8k16 for a 16-deep tail. K past the operand is
//     zero-filled in shared memory and never read.
//   * a block tile chosen from M, N and the SM count, not the caller's (bm,
//     bn): the first of 128 x 128, 64 x 128 and 64 x 64 that gives a block
//     for every SM, else 64 x 64 (the im2col shape: 256 blocks, two an SM).
//     8 warps as 2 (rows) x 4 (columns), each owning 64 x 32, 32 x 32 or
//     32 x 16 int32 sums in C fragments (tall warp tiles: fewer B loads per
//     product), at most 128 registers so that two blocks share an SM. Rows
//     and columns past M and N are zero-filled and not stored. Each block
//     owns its output tile and walks K itself: no atomics, no split of K, the
//     same bits from every launch.
//   * staging: 128-deep K stages through a ring of three cp.async slots, two
//     stages in flight while one is multiplied, one barrier a stage; the
//     copies go through L1 (cp.async.ca: every block reads all of w, and the
//     L2-only form took twice as long for it). x rows are K-contiguous, the A
//     operand's layout: 16-byte copies at a row pitch of 144 bytes, read back
//     with ldmatrix, 16 rows of a k32 step in one instruction, on 32 distinct
//     banks. w is (K, N), N-contiguous, and a B-fragment word holds four
//     K-consecutive codes of one column: each thread copies a block of four
//     rows by 16 columns (neighbouring lanes on neighbouring columns, so a
//     warp reads whole row segments) and transposes it in place into 16
//     column words (transpose4x4_s8) at a word-row pitch of BN + 8, so that
//     the B loads hit distinct banks; a block's rows sit in an XOR order, so
//     that the copies and the transpose hit distinct banks too. Only the
//     thread that copied a block reads it: no barrier between copy and
//     transpose. Operands whose rows or pointers are not 16-byte aligned take
//     the same kernel with 8- or 4-byte copies, or with element copies,
//     chosen at launch.
//   * the flush is `flush_frags` (epilogue.cuh) with the dequant step alone,
//     from the tile's scale row staged in shared memory, two adjacent columns
//     a float2 store.
#include <limits.h>

#include "cp_async.cuh"
#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace hapm {

constexpr int kI8Threads = 256;
constexpr int kI8Stage = 128;             // K codes of a stage
constexpr int kI8Stages = 3;              // ring slots
constexpr int kI8PitchX = kI8Stage + 16;  // bytes per staged x row: 36 words, 4 mod 32
constexpr int kI8WordRows = kI8Stage / 4;  // B-fragment word rows of a stage
constexpr int kI8MaxCallerTile = 128;     // the caller's bm, bn (alignment contract)

template <int BM, int BN>
struct I8Tile {
  static constexpr int kPitchW = BN + 8;  // words per word row: 8 mod 32
  static constexpr int kSlotX = BM * kI8PitchX;
  static constexpr int kSlotW = kI8WordRows * kPitchW * 4;
  static constexpr size_t kSmem = kI8Stages * static_cast<size_t>(kSlotX + kSlotW);
  static constexpr int kWarpRows = BM / 2;  // warps: 2 (rows) x 4 (columns)
  static constexpr int kWarpCols = BN / 4;
  static constexpr int MT = kWarpRows / 16;  // m16 tiles of a warp
  static constexpr int NT = kWarpCols / 8;   // n8 tiles of a warp
  static constexpr int kXCopies = BM * (kI8Stage / 16) / kI8Threads;  // x chunks a thread
  static constexpr int kWBlocks = kI8WordRows * (BN / 16);  // 4 x 16-byte w blocks a stage
  static_assert(kXCopies >= 1 && kWBlocks <= kI8Threads && kWBlocks % 32 == 0 && MT >= 1 &&
                    NT >= 1 && kI8WordRows == 32, "tile");
};

// 16 bytes of a row into shared memory as 16 / V copies of V bytes through
// L1 (cp.async.ca); bytes at or past `valid` are zeros and are not read
// (`valid` is a multiple of V, any count for element copies). `any` is a
// readable address for the copies that read nothing.
template <int V>
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src, int valid,
                                       const int8_t* any) {
  if constexpr (V == 1) {
    unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 16; ++c)
      if (c < valid) v[c / 4] |= static_cast<unsigned>(static_cast<uint8_t>(src[c])) << (8 * (c % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 16; c += V) {
      const bool ok = c < valid;
      cp_async_zfill<V>(dst + c, ok ? src + c : any, ok ? V : 0);
    }
  }
}

// Block b: N-tile j = b % n_cols of M-tile i = b / n_cols, so that the blocks
// that share an x row tile run side by side. V: bytes a copy (16, 8 or 4
// through cp.async; 1: element copies).
template <int BM, int BN, int V>
__global__ void __launch_bounds__(kI8Threads, 2)
int8_matmul_imma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                        int N, int n_cols) {
  using T = I8Tile<BM, BN>;
  constexpr int PX = kI8PitchX / 4;  // x row pitch in words
  constexpr int PW = T::kPitchW;
  extern __shared__ __align__(16) unsigned char i8_smem[];
  __shared__ float s_scale[BN];  // the tile's dequant row (0 past N)
  auto xs = [&](int u) { return reinterpret_cast<int8_t*>(i8_smem) + (u % kI8Stages) * T::kSlotX; };
  auto ws = [&](int u) {
    return reinterpret_cast<int*>(i8_smem + kI8Stages * T::kSlotX + (u % kI8Stages) * T::kSlotW);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // mma groupID
  const int tq = lane & 3;   // mma thread in group
  const int m0 = (blockIdx.x / n_cols) * BM;
  const int n0 = (blockIdx.x % n_cols) * BN;
  const int n_stages = (K + kI8Stage - 1) / kI8Stage;

  // x: this thread copies bytes xc .. xc+15 of rows xr + XRP*p of every stage
  constexpr int XC = kI8Stage / 16;     // 16-byte copies a row
  constexpr int XRP = kI8Threads / XC;  // rows a pass
  const int xr = tid / XC;
  const int xc = (tid % XC) * 16;
  // w: this thread (tid < kWBlocks) copies word row wk (code rows 4wk ..
  // 4wk+3) of columns 16wb .. 16wb+15. Neighbouring lanes take neighbouring
  // column blocks, so that a warp's copy reads whole row segments of the
  // tile (128 bytes a row at BN = 128). Row r of a block lands in its 16-byte
  // slot r ^ wsw: eight neighbouring lanes then write and read 32 distinct
  // banks.
  constexpr int NB = BN / 16;  // column blocks of a row
  const bool w_copier = tid < T::kWBlocks;
  const int wb = lane % NB;
  const int wk = lane / NB + (32 / NB) * warp;
  const int wsw = (wb >> 1) & 3;
  const int w_off = wk * PW + 16 * wb;  // the block's first word in a slot
  const int w_cols = N - (n0 + 16 * wb);  // columns of the block inside N

  auto stage = [&](int u) {
    const int k0 = u * kI8Stage;
    int8_t* xd = xs(u);
#pragma unroll
    for (int p = 0; p < T::kXCopies; ++p) {
      const int r = xr + XRP * p;
      const int k = k0 + xc;
      const int valid = m0 + r < M ? K - k : 0;
      const int8_t* src = valid > 0 ? x + static_cast<size_t>(m0 + r) * K + k : x;
      copy16<V>(xd + r * kI8PitchX + xc, src, valid, x);
    }
    if (w_copier) {
      int8_t* wd = reinterpret_cast<int8_t*>(ws(u) + w_off);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + 4 * wk + r;
        const int valid = k < K ? w_cols : 0;
        const int8_t* src = valid > 0 ? w + static_cast<size_t>(k) * N + n0 + 16 * wb : w;
        copy16<V>(wd + 16 * (r ^ wsw), src, valid, w);
      }
    }
  };

  // The block this thread copied into stage u, transposed in place: column
  // n0 + 16wb + c's word (codes of rows 4wk .. 4wk+3) at word w_off + c.
  auto convert = [&](int u) {
    if (!w_copier) return;
    int4* p = reinterpret_cast<int4*>(ws(u) + w_off);
    const int4 r0 = p[0 ^ wsw], r1 = p[1 ^ wsw], r2 = p[2 ^ wsw], r3 = p[3 ^ wsw];
    int4 t[4] = {transpose4x4_s8(make_int4(r0.x, r1.x, r2.x, r3.x)),
                 transpose4x4_s8(make_int4(r0.y, r1.y, r2.y, r3.y)),
                 transpose4x4_s8(make_int4(r0.z, r1.z, r2.z, r3.z)),
                 transpose4x4_s8(make_int4(r0.w, r1.w, r2.w, r3.w))};
    // column group c goes to slot c; the j-th store takes group j ^ wsw
    // (selects, not a runtime index into t)
    if (wsw & 1) {
      const int4 a = t[0], b = t[2];
      t[0] = t[1], t[1] = a, t[2] = t[3], t[3] = b;
    }
    if (wsw & 2) {
      const int4 a = t[0], b = t[1];
      t[0] = t[2], t[1] = t[3], t[2] = a, t[3] = b;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j ^ wsw] = t[j];
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int a = 0; a < T::MT; ++a)
#pragma unroll
    for (int n = 0; n < T::NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][n][c] = 0;
  const int wr0 = (warp >> 2) * T::kWarpRows;  // the warp's first row in the tile
  const int wc0 = (warp & 3) * T::kWarpCols;   // and its first column

  // stage u's products: 32-deep steps, a 16-deep tail as one k16 step
  auto products = [&](int u) {
    const int depth = min(kI8Stage, K - u * kI8Stage);
    const int* xa = reinterpret_cast<const int*>(xs(u)) + (wr0 + gq) * PX + tq;
    // ldmatrix rows: lane l points at row l % 16, bytes 16 * (l / 16) of a step
    const int8_t* xl = xs(u) + (wr0 + (lane & 15)) * kI8PitchX + 16 * (lane >> 4);
    const int* wbp = ws(u) + tq * PW + wc0 + gq;
#pragma unroll
    for (int st = 0; st < kI8Stage / 32; ++st) {
      if (32 * st >= depth) break;
      const int* a = xa + 8 * st;
      const int* b = wbp + 8 * st * PW;
      if (depth - 32 * st > 16) {
        int af[T::MT][4];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) ldmatrix_x4(af[mt], xl + 16 * mt * kI8PitchX + 32 * st);
#pragma unroll
        for (int n = 0; n < T::NT; ++n) {
          const int b0 = b[8 * n];
          const int b1 = b[4 * PW + 8 * n];
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt)
            mma_k32(acc[mt][n], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
        }
      } else {
        int af[T::MT][2];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          af[mt][0] = a[16 * mt * PX];
          af[mt][1] = a[16 * mt * PX + 8 * PX];
        }
#pragma unroll
        for (int n = 0; n < T::NT; ++n) {
          const int b0 = b[8 * n];
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) mma_k16(acc[mt][n], af[mt][0], af[mt][1], b0);
        }
      }
    }
  };

  // stages 0 .. kI8Stages-2 are requested now, one cp.async group each
  // (empty past the last stage, so that the group count stays fixed)
#pragma unroll
  for (int s = 0; s < kI8Stages - 1; ++s) {
    if (s < n_stages) stage(s);
    cp_async_commit();
  }
  for (int c = tid; c < BN; c += kI8Threads) s_scale[c] = n0 + c < N ? scale[n0 + c] : 0.0f;
  cp_async_wait<kI8Stages - 2>();  // this thread's copies of stage 0 have landed
  if (n_stages > 0) convert(0);
  __syncthreads();

  for (int u = 0; u < n_stages; ++u) {
    // into the slot stage u-1 has left: every warp finished its products
    // before the barrier that ended the last iteration
    if (u + kI8Stages - 1 < n_stages) stage(u + kI8Stages - 1);
    cp_async_commit();
    products(u);
    if (u + 1 < n_stages) {
      cp_async_wait<kI8Stages - 2>();  // this thread's copies of stage u+1 have landed
      convert(u + 1);
    }
    __syncthreads();
  }

  // flush: rows gq and gq + 8 of each m16 tile, columns 2tq and 2tq + 1 of
  // each n8 tile, through the dequant step of the shared epilogue
  const int col0 = n0 + wc0;
  const Epilogue ep{s_scale + wc0, nullptr, nullptr, 0};
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int r = m0 + wr0 + 16 * mt + gq;
    if (r >= M) break;
    flush_frags<kOutF32, T::NT, 1>(acc[mt], ep, out, static_cast<size_t>(r) * N + col0, N,
                                   M - r, 2 * tq, N - col0, 0u);
  }
}

// The block tile for an (M, N) output: the first of 128 x 128, 64 x 128 and
// 64 x 64 that gives at least one block for every SM of the current device,
// else 64 x 64. tile[0], tile[1] = rows, columns; tile[2] = blocks (-1 past
// INT_MAX).
static cudaError_t choose_tile(int M, int N, int* tile) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int kTiles[3][2] = {{128, 128}, {64, 128}, {64, 64}};
  long long blocks = 0;
  for (int t = 0; t < 3; ++t) {
    tile[0] = kTiles[t][0];
    tile[1] = kTiles[t][1];
    blocks = static_cast<long long>((M + tile[0] - 1) / tile[0]) * ((N + tile[1] - 1) / tile[1]);
    if (blocks >= sms) break;
  }
  tile[2] = blocks > INT_MAX ? -1 : static_cast<int>(blocks);
  return cudaSuccess;
}

template <int BM, int BN, int V>
static cudaError_t launch_i8(const void* x, const void* w, const float* scale, void* out, int M,
                             int K, int N, int blocks, cudaStream_t stream) {
  using T = I8Tile<BM, BN>;
  auto kernel = int8_matmul_imma_kernel<BM, BN, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kI8Threads, T::kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<float*>(out), M, K, N, (N + BN - 1) / BN);
  return cudaGetLastError();
}

template <int BM, int BN>
static cudaError_t launch_i8_copies(int v, const void* x, const void* w, const float* scale,
                                    void* out, int M, int K, int N, int blocks,
                                    cudaStream_t stream) {
  switch (v) {
    case 16:
      return launch_i8<BM, BN, 16>(x, w, scale, out, M, K, N, blocks, stream);
    case 8:
      return launch_i8<BM, BN, 8>(x, w, scale, out, M, K, N, blocks, stream);
    case 4:
      return launch_i8<BM, BN, 4>(x, w, scale, out, M, K, N, blocks, stream);
    default:
      return launch_i8<BM, BN, 1>(x, w, scale, out, M, K, N, blocks, stream);
  }
}

}  // namespace hapm

// The block tile and block count the kernel takes for an (M, N) output on
// the current device: tile[0] rows, tile[1] columns, tile[2] blocks (-1 past
// INT_MAX). Returns a cudaError_t (0 = success).
extern "C" int hapm_int8_matmul_tile(int M, int N, int* tile) {
  if (M < 1 || N < 1 || tile == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(hapm::choose_tile(M, N, tile));
}

// x (M, K), w (K, N) row-major int8 codes; scale an f32 row of length N; out
// (M, N) f32. Requires M % bm == 0, N % bn == 0, 1 <= bm <= 128,
// 1 <= bn <= 128 (the caller's tiles; the kernel picks its own). Returns the
// launch's cudaError_t (0 = launched).
extern "C" int hapm_int8_matmul(const void* x, const void* w, const float* scale, void* out,
                                int M, int K, int N, int bm, int bn, void* stream) {
  using namespace hapm;
  if (bm < 1 || bm > kI8MaxCallerTile || bn < 1 || bn > kI8MaxCallerTile || M < 1 || N < 1 ||
      K < 0 || M % bm || N % bn || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile[3];
  cudaError_t err = choose_tile(M, N, tile);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile[2] < 1) return static_cast<int>(cudaErrorInvalidValue);
  // copies of V bytes stay inside a row and on V-byte addresses when V
  // divides both pointers, K and N
  auto fits = [&](int v) {
    return reinterpret_cast<uintptr_t>(x) % v == 0 && reinterpret_cast<uintptr_t>(w) % v == 0 &&
           K % v == 0 && N % v == 0;
  };
  const int v = fits(16) ? 16 : fits(8) ? 8 : fits(4) ? 4 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile[0] == 128)
    err = launch_i8_copies<128, 128>(v, x, w, scale, out, M, K, N, tile[2], st);
  else if (tile[1] == 128)
    err = launch_i8_copies<64, 128>(v, x, w, scale, out, M, K, N, tile[2], st);
  else
    err = launch_i8_copies<64, 64>(v, x, w, scale, out, M, K, N, tile[2], st);
  return static_cast<int>(err);
}
