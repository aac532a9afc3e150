// Block-sparse weight gradient for Hopper (sm_90a): the dW half of every
// block-sparse backward.
//
// Replaces the Pallas TPU kernel `block_sparse_grad_weight`
// (src/repro/kernels/block_sparse_matmul.py:257, body `_grad_w_kernel`):
//
//   dw[l] = x[:, kk[l]-tile]^T @ g[:, nn[l]-tile]        for the L live tiles
//
// a compact (L, bk, bn) f32 stack; the caller scatters it onto the (K, N)
// grid, so dead tiles are never computed and stay exactly zero.
//
// What bounds it on this card: bytes. Every live tile contracts the whole
// row axis (M = B*ho*wo, up to 131072 at training batch 128) of a narrow x
// column block (bk = 8 or 16 unpacked, 128 packed) against a 128-lane g
// column block. The operations are 2*M*bk*bn a tile, which the tensor cores
// do as 3xTF32 faster than the card reads the operands of the narrow
// unpacked tiles; what is left is reading x's live column blocks and g's
// lanes (of which a 12-filter group fills 12 of 128: the rest are exact
// zeros on the training path) and writing the partial sums of the row
// chunks. The packed (128, 128) tiles do 128 times the products per byte
// and come near the tensor cores' rate for mma.sync with the 3xTF32 split.
//
// What the design does about it:
//   * one block per (stack, row chunk). A stack is up to 128 / bk live tiles
//     of ONE output column n, in the caller's order (`grad_weight_stacks` in
//     kernels/block_sparse_matmul.py builds the table once per bind): eight
//     (16, 128) tiles of the unpacked 3x3 layout, sixteen (8, 128) ones of
//     the unpacked 1x1 layout, one (128, 128) packed tile. Its tiles' x
//     columns stand side by side as the 128 rows of the mma's M side, so the
//     block stages each g row slice once for all of them, where one block a
//     tile re-read g for each of the 8-32 live tiles of an unpacked column.
//   * the rows of a chunk move through a ring of three 32-row slices with
//     cp.async (16-byte copies; rows past the chunk's end are filled with
//     zeros), x's stacked columns and g's bn lanes each at a row pitch of 136
//     elements. The fragments read down the rows of a staged slice, A[i][k] =
//     x[m0+k][k0+i] and B[k][j] = g[m0+k][n0+j]; with a pitch of 8 words
//     (mod 32) the tf32 fragment loads (k = lane % 4, i or j = lane / 4) fall
//     on 32 distinct banks with no transpose buffer, and the bf16 ones (two
//     K-adjacent rows packed into a word) on 16 distinct words.
//   * products on the tensor cores (csrc/mma_f32.cuh). 8 warps, each one m16
//     tile of the 128 stacked rows by all 16 n8 tiles of the lanes. f32 runs
//     as 3xTF32 on m16n8k8 tiles; bf16 on m16n8k16 tiles. Every 8-row (f32)
//     or 16-row (bf16) step is summed into a zeroed fragment and added to the
//     running sum with one round-to-nearest f32 add: chaining the steps
//     through the tensor cores' truncating accumulator biased a long sum
//     past the float64 gradient bar in the implicit conv (PR 16).
//   * lane padding is neither read nor multiplied. The bind passes the conv
//     layout's lane count (`g_lanes`: 12 of 128 for a 12-filter group
//     unpacked, 120 packed; every lane by default): g is zero past it, so
//     the block stages the lanes up to the next multiple of 8 and writes 0
//     past them. Within them, while a slice lands, each thread reads back
//     the g copies it made and notes the n8 lane tiles holding a value
//     other than +-0; the block ORs the notes and skips the products of
//     whatever is all zero in the slice. For finite x the skipped products
//     are exact zeros, so the result is unchanged. A NaN or Inf in x meets
//     such a zero lane only where the plain version gives NaN (0 * Inf) and
//     the kernel gives 0; a non-finite g is never skipped.
//   * the products run as straight-line code in runs that the scheduler
//     overlaps: with one branch per n8 tile the compiler serialised every
//     tile's chain of three dependent mma. At most 16 staged lanes (the
//     unpacked layouts) take one run of n8 tiles 0 and 1 over the slice's
//     K steps; wider lanes take, per K step, every group of four n8 tiles
//     (32 lanes) with a nonzero tile. A tile of a run whose lanes are zero
//     adds exact zeros; one past the staged lanes is written as 0.
//   * fixed order, no float atomics: a tile's rows are split into S chunks
//     of a fixed length (`grad_weight_split`: a function of M, the number of
//     stacks and the SM count, for about two blocks an SM). Each block
//     writes its tiles' partial sums to a workspace ws[s, l] (or straight to
//     out when S == 1), and a second pass sums the S partials of every
//     element in chunk order. Two launches on the same inputs give the same
//     bits.
//   * each thread copies one fixed 16-byte column of every staged row slice
//     (x's stacked columns and g's lanes), chosen once per block, so the
//     slice loop does no index arithmetic; operands whose rows or pointers
//     are not 16-byte aligned take the same kernel with element copies (no
//     cp.async) instead.
//   Shared memory: 3 x 32 rows x 136 elements for x and for g, 104 KB for
//   f32 and 52 KB for bf16, so that two blocks share an SM.
#include "cp_async.cuh"
#include "epilogue.cuh"
#include "mma_f32.cuh"

namespace hapm {

constexpr int kGwThreads = 256;
constexpr int kGwWarps = kGwThreads / 32;
constexpr int kGwRows = 16 * kGwWarps;  // stacked tile rows of a block: 128
constexpr int kGwSliceM = 32;           // rows staged per ring slot (the chunk unit)
constexpr int kGwStages = 3;
constexpr int kGwPitch = kMaxBn + 8;    // elements per staged row

template <typename T>
constexpr size_t kGwRingBytes = 2 * kGwStages * kGwSliceM * kGwPitch * sizeof(T);
template <typename T>
constexpr size_t kGwSmemBytes =
    kGwRingBytes<T> + (kGwStages * kGwWarps + 2 * kGwRows) * sizeof(int);

// does a unit hold a value other than +-0 (NaN counts as a value)?
template <typename T>
__device__ __forceinline__ bool unit_nonzero(uint4 v) {
  constexpr uint32_t kMag = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  return ((v.x | v.y | v.z | v.w) & kMag) != 0;
}
template <typename T>
__device__ __forceinline__ bool unit_nonzero(uint32_t v) { return (v & 0x7fffffffu) != 0; }
template <typename T>
__device__ __forceinline__ bool unit_nonzero(uint16_t v) { return (v & 0x7fffu) != 0; }

// A thread's part of every slice copy: one unit column u = tid % UR of x's
// stacked columns and of g's lanes (UR units make 128 columns), in rows
// tid / UR + RP*i. Fixed for the block, so the slice loop does no index
// arithmetic beyond a row offset.
template <typename T, bool kVec>
struct GwCopyPlan {
  static constexpr int U = CopyUnit<T, kVec>::elems;
  static constexpr int UR = kMaxBn / U;                   // units per row
  static constexpr int RP = kGwThreads / UR;              // rows per pass
  static constexpr int kPasses = kGwSliceM / RP;
  static_assert(kGwThreads % UR == 0 && kGwSliceM % RP == 0, "copy plan");
  int r0;        // first row
  int xcol, xdst;  // x: column in a row of x and in a staged row, or xdst < 0
  int gcol, gdst;  // g: the same for g's lanes, or gdst < 0

  __device__ __forceinline__ GwCopyPlan(const int* k0s, int nt, int bk, int lanes, int n0,
                                        int tid) {
    const int u = tid % UR;
    const int ux = bk / U;  // units per tile row
    r0 = tid / UR;
    const int t = u / ux;
    const int c = (u - t * ux) * U;
    const bool has_x = t < nt;
    xcol = has_x ? k0s[t] + c : 0;
    xdst = has_x ? t * bk + c : -1;
    gcol = n0 + u * U;
    gdst = u * U < lanes ? u * U : -1;
  }

  // Stage rows m0 .. m0+rows-1 of the stack's x columns and g's lanes into
  // one ring slot; its rows past `rows` are zeros.
  __device__ __forceinline__ void stage(T* xslot, T* gslot, const T* __restrict__ x,
                                        const T* __restrict__ g, int m0, int rows, int K,
                                        int N) const {
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = r0 + RP * i;
      const bool ok = r < rows;
      const size_t row = static_cast<size_t>(m0 + (ok ? r : 0));
      if (xdst >= 0) copy_unit<T, kVec>(xslot + r * kGwPitch + xdst, x + row * K + xcol, ok);
      if (gdst >= 0) copy_unit<T, kVec>(gslot + r * kGwPitch + gdst, g + row * N + gcol, ok);
    }
  }

  // Bit n set: this thread's copies of the slot's first `rows` g rows hold
  // a nonzero value in lanes 8n .. 8n+7. Reads only what this thread copied,
  // so it needs cp.async.wait_group and no barrier.
  __device__ __forceinline__ uint32_t scan(const T* gslot, int rows) const {
    using Unit = typename CopyUnit<T, kVec>::type;
    if (gdst < 0) return 0;
    bool nz = false;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = r0 + RP * i;
      if (r < rows)
        nz |= unit_nonzero<T>(*reinterpret_cast<const Unit*>(gslot + r * kGwPitch + gdst));
    }
    return nz ? 1u << (gdst / 8) : 0u;
  }
};

// The products of one staged slice, acc[n] += A^T B over its rows: A the
// warp's m16 rows R0.. of the stacked x columns, B g's n8 lane tile n. f32:
// 3xTF32 on m16n8k8, one K step = 8 rows; bf16: m16n8k16, 16 rows. Rows past
// the chunk's end are zeros and add exact zeros.
template <typename T>
constexpr int kGwStepRows = sizeof(T) == 4 ? 8 : 16;

struct GwAF32 {  // an A fragment split into TF32 halves
  uint32_t hi[4], lo[4];
};
struct GwABF16 {
  uint32_t a[4];
};

// A[i][k] = xs[k0 + k][R0 + i]: rows g, g+8 of the fragment at K t, t+4
__device__ __forceinline__ GwAF32 gw_a_frag(const float* xs, int k0, int R0, int lane) {
  constexpr int P = kGwPitch;
  const float* xa = xs + (k0 + lane % 4) * P + R0 + lane / 4;
  const Tf32Split a0 = split_tf32(xa[0]), a1 = split_tf32(xa[8]);
  const Tf32Split a2 = split_tf32(xa[4 * P]), a3 = split_tf32(xa[4 * P + 8]);
  return {{a0.hi, a1.hi, a2.hi, a3.hi}, {a0.lo, a1.lo, a2.lo, a3.lo}};
}

// bf16: two K-adjacent rows packed into each register
__device__ __forceinline__ GwABF16 gw_a_frag(const __nv_bfloat16* xs_, int k0, int R0,
                                             int lane) {
  constexpr int P = kGwPitch;
  const uint16_t* xa =
      reinterpret_cast<const uint16_t*>(xs_) + (k0 + 2 * (lane % 4)) * P + R0 + lane / 4;
  return {{pack_bf16(xa[0], xa[P]), pack_bf16(xa[8], xa[P + 8]), pack_bf16(xa[8 * P], xa[9 * P]),
           pack_bf16(xa[8 * P + 8], xa[9 * P + 8])}};
}

// acc[n0 .. n0+G-1] += A x (g's n8 tiles n0 ..) over the K step at row k0:
// straight-line code, so that the G product chains overlap. Each chain sums
// into a zeroed fragment that is added to acc with one rounding.
template <int G>
__device__ __forceinline__ void gw_group(float (&acc)[kMaxBn / 8][4], const GwAF32& a,
                                         const float* gs, int k0, int n0, int lane) {
  constexpr int P = kGwPitch;
  const float* gb = gs + (k0 + lane % 4) * P + 8 * n0 + lane / 4;
  Tf32Split b0[G], b1[G];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    b0[n] = split_tf32(gb[8 * n]);
    b1[n] = split_tf32(gb[8 * n + 4 * P]);
  }
#pragma unroll
  for (int n = 0; n < G; ++n) mma_3xtf32(acc[n0 + n], a.hi, a.lo, b0[n], b1[n]);
}

template <int G>
__device__ __forceinline__ void gw_group(float (&acc)[kMaxBn / 8][4], const GwABF16& a,
                                         const __nv_bfloat16* gs_, int k0, int n0, int lane) {
  constexpr int P = kGwPitch;
  const uint16_t* gb = reinterpret_cast<const uint16_t*>(gs_) + (k0 + 2 * (lane % 4)) * P +
                       8 * n0 + lane / 4;
  float t[G][4];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    const uint16_t* b = gb + 8 * n;
#pragma unroll
    for (int q = 0; q < 4; ++q) t[n][q] = 0.0f;
    mma_bf16(t[n], a.a, pack_bf16(b[0], b[P]), pack_bf16(b[8 * P], b[9 * P]));
  }
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n0 + n][q] = __fadd_rn(acc[n0 + n][q], t[n][q]);
}

// `mask`: the slice's n8 tiles holding a nonzero g value. Narrow (at most 16
// staged lanes, the unpacked layouts): n8 tiles 0 and 1 over every K step of
// the slice as one straight-line run. Wide: per K step, each group of four n8
// tiles (32 lanes) with a tile set in `mask`; a tile of a run whose lanes
// are zero adds exact zeros (finite x), a tile past the staged lanes is
// written as 0.
template <bool kNarrow, typename T>
__device__ __forceinline__ void gw_products(float (&acc)[kMaxBn / 8][4], const T* xs,
                                            const T* gs, uint32_t mask, int R0, int lane) {
  constexpr int kSteps = kGwSliceM / kGwStepRows<T>;
  if constexpr (kNarrow) {
    if (!(mask & 3u)) return;
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
      gw_group<2>(acc, gw_a_frag(xs, k * kGwStepRows<T>, R0, lane), gs, k * kGwStepRows<T>, 0,
                  lane);
  } else {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const auto a = gw_a_frag(xs, k * kGwStepRows<T>, R0, lane);
#pragma unroll
      for (int n0 = 0; n0 < kMaxBn / 8; n0 += 4)
        if ((mask >> n0) & 15u) gw_group<4>(acc, a, gs, k * kGwStepRows<T>, n0, lane);
    }
  }
}

// Block (j, s): stack j (row j of `stacks`, `width` tile indices, -1 past
// its nt tiles) over row chunk s; writes its tiles' partial sums to
// dst[s, l] (dst = ws, or out when S == 1). kNarrow: lanes <= 16.
template <typename T, bool kVec, bool kNarrow>
__global__ void __launch_bounds__(kGwThreads, 2)
grad_weight_stack_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const int* __restrict__ kk, const int* __restrict__ nn,
                         const int* __restrict__ stacks, float* __restrict__ dst, int M, int K,
                         int N, int bk, int bn, int lanes, int L, int width, int chunk) {
  extern __shared__ __align__(16) unsigned char gw_smem[];
  T* ring = reinterpret_cast<T*>(gw_smem);
  uint32_t* masks = reinterpret_cast<uint32_t*>(gw_smem + kGwRingBytes<T>);
  int* sl = reinterpret_cast<int*>(masks + kGwStages * kGwWarps);  // tile index of stack slot t
  int* k0s = sl + kGwRows;                                          // its first x column
  constexpr int kSlot = kGwSliceM * kGwPitch;
  auto xs = [&](int st) { return ring + st * kSlot; };
  auto gs = [&](int st) { return ring + (kGwStages + st) * kSlot; };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int s = blockIdx.y;
  const int* row = stacks + static_cast<size_t>(blockIdx.x) * width;
  int l = -1;
  if (tid < width) {
    l = row[tid];
    sl[tid] = l;
    k0s[tid] = l >= 0 ? kk[l] * bk : 0;
  }
  const int nt = __syncthreads_count(l >= 0);  // the -1 entries are at the end
  const GwCopyPlan<T, kVec> plan(k0s, nt, bk, lanes, nn[row[0]] * bn, tid);
  const int m_begin = s * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int n_slices = (m_end - m_begin + kGwSliceM - 1) / kGwSliceM;
  auto stage = [&](int i) {
    const int m0 = m_begin + i * kGwSliceM;
    plan.stage(xs(i % kGwStages), gs(i % kGwStages), x, g, m0, min(kGwSliceM, m_end - m0), K,
               N);
  };

  // slices 0 .. kGwStages-2 are requested now, one cp.async group each
  // (empty past the chunk's end, so that the group count stays fixed)
#pragma unroll
  for (int i = 0; i < kGwStages - 1; ++i) {
    if (i < n_slices) stage(i);
    cp_async_commit();
  }
  float acc[kMaxBn / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxBn / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
  const int R0 = 16 * warp;
  const bool active = R0 < nt * bk;  // a warp whose rows are past the stack's tiles idles
  for (int i = 0; i < n_slices; ++i) {
    const int st = i % kGwStages;
    const int rows = min(kGwSliceM, m_end - (m_begin + i * kGwSliceM));
    cp_async_wait<kGwStages - 2>();  // this thread's copies of slice i have landed
    const uint32_t bits = __reduce_or_sync(0xffffffffu, plan.scan(gs(st), rows));
    if (lane == 0) masks[st * kGwWarps + warp] = bits;
    // slice i is in place and its lane notes are complete; every warp is
    // done with slice i-1, whose slot the next request reuses
    __syncthreads();
    if (i + kGwStages - 1 < n_slices) stage(i + kGwStages - 1);
    cp_async_commit();
    uint32_t mask = 0;
#pragma unroll
    for (int w = 0; w < kGwWarps; ++w) mask |= masks[st * kGwWarps + w];
    if (active) gw_products<kNarrow>(acc, xs(st), gs(st), mask, R0, lane);
  }
  if (!active) return;

  // C fragment: rows R0 + lane/4 (+8), columns 8n + 2*(lane%4) (+1); the
  // lanes past `lanes` were never staged, and g is zero there
  const auto value = [&](int c, float v) { return c < lanes ? v : 0.0f; };
  const size_t tile = static_cast<size_t>(bk) * bn;
  float* base = dst + static_cast<size_t>(s) * L * tile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = R0 + lane / 4 + 8 * h;
    if (R >= nt * bk) continue;
    const int t = R / bk;
    float* o = base + static_cast<size_t>(sl[t]) * tile + static_cast<size_t>(R - t * bk) * bn;
#pragma unroll
    for (int n = 0; n < kMaxBn / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      if (c < bn) o[c] = value(c, acc[n][2 * h]);
      if (c + 1 < bn) o[c + 1] = value(c + 1, acc[n][2 * h + 1]);
    }
  }
}

// out[i] = ws[0, i] + ws[1, i] + ... + ws[S-1, i], left to right; the loads
// go out eight at a time, ahead of their adds.
__global__ void grad_weight_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                          int S, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = ws[i];
  int s = 1;
  for (; s + 8 <= S; s += 8) {
    float p[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) p[q] = ws[static_cast<size_t>(s + q) * total + i];
#pragma unroll
    for (int q = 0; q < 8; ++q) v += p[q];
  }
  for (; s < S; ++s) v += ws[static_cast<size_t>(s) * total + i];
  out[i] = v;
}

struct GwArgs {
  const void* x;
  const void* g;
  const int* kk;
  const int* nn;
  const int* stacks;
  float* ws;
  float* out;
  int M, K, N, bk, bn, lanes, L, n_stacks, width, S, chunk;
};

template <typename T, bool kVec, bool kNarrow>
static cudaError_t launch_stacks(const GwArgs& a, cudaStream_t stream) {
  auto kernel = grad_weight_stack_kernel<T, kVec, kNarrow>;
  constexpr size_t smem = kGwSmemBytes<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_stacks, a.S), dim3(kGwThreads), smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.kk, a.nn, a.stacks,
      a.S == 1 ? a.out : a.ws, a.M, a.K, a.N, a.bk, a.bn, a.lanes, a.L, a.width, a.chunk);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const GwArgs& a, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.g) % 16 == 0 && (a.K * es) % 16 == 0 &&
                   (a.N * es) % 16 == 0 && (a.bk * es) % 16 == 0 && (a.bn * es) % 16 == 0 &&
                   (a.lanes * es) % 16 == 0;
  const bool narrow = a.lanes <= 16;
  cudaError_t err = vec ? (narrow ? launch_stacks<T, true, true>(a, stream)
                                  : launch_stacks<T, true, false>(a, stream))
                        : (narrow ? launch_stacks<T, false, true>(a, stream)
                                  : launch_stacks<T, false, false>(a, stream));
  if (err != cudaSuccess || a.S == 1) return err;
  const size_t total = static_cast<size_t>(a.L) * a.bk * a.bn;
  const unsigned blocks = static_cast<unsigned>((total + kGwThreads - 1) / kGwThreads);
  grad_weight_reduce_kernel<<<blocks, kGwThreads, 0, stream>>>(a.ws, a.out, a.S, total);
  return cudaGetLastError();
}

}  // namespace hapm

// x (M, K), g (M, N) row-major of `dtype` (f32 or bf16), g zero in the lanes
// past `lanes` (1..bn) of every bn-lane column: those lanes are not read and
// their dW is 0 (lanes = bn reads all); kk, nn (L,) int32
// live-tile coordinates in any order; stacks (n_stacks, width) int32: row j
// lists the indices into kk/nn of up to `width` live tiles of one output
// column, -1 past the last, every tile in exactly one row
// (`grad_weight_stacks`); ws (S, L, bk, bn) f32 scratch (null when S == 1);
// out (L, bk, bn) f32. Rows are split into S chunks of `chunk` rows (a
// multiple of 32; (S-1)*chunk < M <= S*chunk). Requires K % bk == 0,
// N % bn == 0, bk <= 128, bn <= 128, width * bk <= 128, 1 <= n_stacks <= L,
// M >= 1. Returns the launches' cudaError_t (0 = launched).
extern "C" int hapm_block_sparse_grad_weight(const void* x, const void* g, const int* kk,
                                             const int* nn, const int* stacks, float* ws,
                                             float* out, int M, int K, int N, int bk, int bn,
                                             int lanes, int L, int n_stacks, int width, int S,
                                             int chunk, int dtype, void* stream) {
  using namespace hapm;
  if (x == nullptr || g == nullptr || kk == nullptr || nn == nullptr || stacks == nullptr ||
      out == nullptr || bk < 1 || bk > kGwRows || bn < 1 || bn > kMaxBn || lanes < 1 ||
      lanes > bn || K % bk ||
      N % bn || L < 1 || M < 1 || n_stacks < 1 || n_stacks > L || width < 1 ||
      width * bk > kGwRows || S < 1 || S > 65535 || chunk < 1 || chunk % kGwSliceM ||
      static_cast<long long>(S) * chunk < M || static_cast<long long>(S - 1) * chunk >= M ||
      (S > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // stage whole n8 tiles: the lanes up to the next multiple of 8 are zeros
  const int lanes8 = (lanes + 7) / 8 * 8 < bn ? (lanes + 7) / 8 * 8 : bn;
  const GwArgs a{x, g, kk, nn, stacks, ws, out, M, K, N, bk, bn, lanes8, L, n_stacks, width, S,
                 chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float>(a, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(a, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
