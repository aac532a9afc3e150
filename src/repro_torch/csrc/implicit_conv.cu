// Implicit-im2col block-sparse convolution for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel `implicit_block_sparse_conv`
// (src/repro/kernels/implicit_conv.py:347, body `_kernel`): the same GEMM
// and epilogue as the block-sparse matmul, but the x operand is the padded
// NHWC activation left in device memory. For M-block (b, p) and live K-tile
// t the kernel reads the window
//     xp[b, r0 : r0+rows, q0 : q0+cols, t*cpk : (t+1)*cpk]
// and multiplies the patch rows
//     pt[oh*block_ow + ow, c*slot + dy*ky + dx] = win[oh*stride+dy, ow*stride+dx, c]
// (zero elsewhere) with the (bk, bn) weight tile. The patch matrix never
// exists in device memory. Both instances below share this contract: one
// thread block per (M-block i, N-tile j), the TPU grid's sequential third
// axis a loop over the live tiles of column j with the accumulator in
// registers; a column with cnt[j] == 0 still flushes the epilogue on zeros,
// and the rows of the M-block past block_oh*block_ow flush the epilogue of
// a zero accumulator, as in the TPU kernel.
//
// Activation DSB (int8 codes only): a live step is skipped when the WHOLE
// staged window of its K-tile's cpk channels is zero (not only the tapped
// pixels: with stride 2 they differ), uniformly for the block; the
// accumulator is untouched, so the result is bit-identical; skips[i, j]
// counts the skipped steps, written by one thread.
//
// int8 codes (`implicit_conv_kernel_imma`, serving and pricing). What bounds
// it: bytes, once the products are on the tensor cores. A step's products
// are at most bm*bk*bn int8 multiply-adds, most of them on lane padding (a
// 3x3 group of 12 filters fills 12 of a tile's 128 lanes and 9 of its 16
// rows), and the tensor cores do them at 1979 TOP/s; what is left is staging
// the operands and writing the padded output array (bm rows x 128 lanes of
// codes an M-block). What sets its time on the served layers (2048-16384
// M-blocks of one column) is neither: it is each block's chain of dependent
// phases. Timed by clock64 stamps in the one-block-per-(M-block, N-tile)
// body at batch 2048, a block spent 30-38 % of its time in its prologue
// (tables, epilogue rows, window) and in copying and transposing its
// column's weight units from L2, 34-60 % in the products and 6-16 % in the
// flush, whose 2-byte stores write 8 bytes of each 32-byte sector. So the
// instance has two bodies. The host chooses between them from the launch's
// geometry (`takes_resident_path` in kernels/implicit_conv.py, the rule's
// only copy); the launcher refuses a resident launch on padded operands or
// one whose shared memory a block cannot hold:
//   * resident (kResident, compacted K operands only): as many blocks as the
//     card holds at once, each holding every weight unit of its column,
//     copied and transposed once into its own packed buffer (17 KB a unit),
//     with the window offset of each of their rows formed once from the
//     table, then walking M-blocks c, c + G, ... Each M-block's window (all
//     channels, pixels padded to an odd number of 16-byte groups) is
//     requested one M-block ahead into a ring of two; a whole 128-row unit
//     runs its four K steps as straight-line code; its codes go through
//     staging rows in shared memory (the zero-accumulator codes written
//     once, only the live n8 tiles rewritten per M-block) and leave in
//     16-byte stores of whole rows. The two warps of an m16 tile (bm = 64)
//     take alternate n8 tiles, so that a column's live tiles at the front
//     split evenly. Taken where the column's units, the ring and the staging
//     fit a block and each block walks at least two M-blocks: every conv of
//     the served CIFAR net at batch 2048. What is left of its time is the
//     products (85-95 % of an M-block by the same stamps): the A-fragment
//     gathers, a byte load per code, bound by latency at 8-16 warps an SM,
//     not by the banks (a window laid out so that every load takes one
//     wavefront ran no faster).
//   * per block (padded or compacted K operands): one block per (M-block,
//     N-tile), the column's units streamed through a raw ring for that
//     M-block alone, as below: batch-1 and small-batch serving, pricing,
//     windows or columns too large to hold, and every launch on padded
//     operands (activation DSB, calls that are not prebound).
// Compacted K (kCompact, every prebound int8 launch without activation DSB
// whose window of all channels the per-block body holds): a packed K-tile
// gives each channel ceil8(kx*ky) rows, so a 1x1 tile holds one tap in
// eight rows and a 3x3 tile nine in sixteen, and no K step of either is
// all padding. The bind (compact_k in kernels/implicit_conv.py) lists for
// each column j only the tap rows of its live tiles (tiles in the table's
// order, channels below cin, taps row-major), krows[j] of them rounded up
// to 32, and gathers those rows of the packed weight into a compacted
// weight of kpad rows beside a table of each row's (channel, dy, dx). Both
// bodies then walk a column's rows in units of 128 (the last one partial)
// and gather A fragments through the table's window offsets (channel
// included) from the window of all channels; the weight ring, transpose,
// n8 masks, window ring, staging and epilogue are as below. The per-block
// body forms a unit's offsets when it converts the unit (the table rides in
// the raw stage), the resident one all of them once. ResNet-50's 1x1s
// multiply 8x fewer rows, its 3x3s 1.78x, and its 1x1 columns of 256-1024
// channels fit the resident path. The plan and the tables the dispatch
// keeps are unchanged, int32 sums are exact in any order, and the codes are
// those of the padded tiles. Binds with activation DSB keep the padded
// tiles: their skip is decided per K-tile window. So does the slow path
// below (a compacted unit mixes K-tiles).
// The per-block body, whose products and epilogue the resident one shares:
//   * products on the tensor cores: mma.sync m16n8k32 (s8 x s8 -> s32) per
//     32-deep K-step, m16n8k16 for a 16-deep one (bk = 16, the unpacked 3x3
//     layout; bk = 8 is padded to 16). int32 sums are exact in any order, so
//     the result equals the plain version bit for bit. K-steps whose rows
//     all lie in patch padding (tap >= kx*ky, channel >= cpk, k >= bk) are
//     skipped, and so are the n8 tiles past the last one whose weights hold
//     a nonzero code (the lane padding at the end of a tile). 8 warps: MT
//     m16 tiles (bm <= 16*MT) by 8/MT warps along N, each warp over 2*MT n8
//     tiles of the bn <= 128 lanes; at most 128 registers, so that two
//     blocks share an SM.
//   * the window is staged once per block with ALL Cp channels (one
//     contiguous run of cols*Cp bytes per window row, cp.async in 16-byte
//     chunks where aligned), so a live step stages no activation and reads
//     its channel slice from shared memory. Every live step's skip is
//     decided from that copy before the loop, and the loop runs over the
//     steps that are not skipped. Where all channels do not fit in shared
//     memory, the block restages the (rows, cols, cpk) slice per live step
//     and decides the skip then (the slow path of huge windows).
//   * weights move in units of up to 128 rows: 128 / bk16 whole K-tiles
//     (eight of the unpacked 3x3 layout's 16-row tiles) or a 128-row part of
//     a deeper tile. An mma B fragment wants four K-consecutive codes of a
//     column in one word, but the tile's rows are N-contiguous: each thread
//     copies 4x4-byte blocks of a unit with cp.async into a raw ring three
//     units deep, then transposes its own blocks with byte permutes into a
//     packed buffer (row pitch 136 words: B-fragment loads are conflict-
//     free), noting which n8 tiles hold a nonzero code. One barrier per
//     unit; the first unit is requested with the window, before the skips
//     are known, and again only if a skip changed it.
//   * A fragments are gathered in registers straight from the staged window
//     (one byte load per code through a per-block table of the K index's
//     window offset, four codes packed per word): with one m16 tile per
//     warp row every code is read once, where an ldmatrix path would first
//     write the patch tile to shared memory.
//   * the flush runs the shared `flush_epilogue` on this column's epilogue
//     rows, staged in shared memory; two adjacent columns go out in one
//     store (2 bytes of int8 codes or 8 of f32). An n8 tile whose weights
//     are zero in every unit holds the epilogue of a zero accumulator in
//     every row, which the block writes in 16-byte stores from a row
//     computed once.
//
// f32 and bf16 operands (`implicit_conv_kernel`, the forward of every bound
// conv in training). What bounds it: bytes, as for the int8 instance: a
// step's products are at most bm*bk*bn multiply-adds, most of them on lane
// padding (12 of a tile's 128 lanes for a 12-filter group), while each block
// writes bm rows x 128 lanes of f32 and stages 128-lane weight rows. What
// sets its time on the CIFAR net: where the grid fills the card (unpacked
// layers, batch 128), writing that padded output and staging the weights;
// where it does not (a packed 64-channel layer has one column of M-blocks,
// one block an SM), each block's serial chain of weight units and their
// products. The design is the int8 instance's, with float fragments
// (csrc/mma_f32.cuh):
//   * f32 operands multiply as 3xTF32 on m16n8k8 tiles: both operands split
//     into hi = tf32(x) and lo = tf32(x - hi), a_lo*b_hi + a_hi*b_lo summed
//     before a_hi*b_hi into a zeroed fragment per K step, which is then
//     added to the running sum with one round-to-nearest f32 add (the
//     tensor cores' own accumulation truncates: chained over the whole K
//     loop it put the training gradients past the float64 bar). TF32 alone
//     misses the 1e-4 bar. bf16 operands multiply on m16n8k16 tiles (exact
//     products, f32 sums). A K step is 8 rows (tf32) or 16 (bf16); a step
//     whose rows all lie in patch padding (tap >= kx*ky, channel >= cpk,
//     k >= bk) is skipped, and so are the n8 tiles past the last one whose
//     weights in the unit hold a nonzero value (the lane padding). 8 warps:
//     MT m16 tiles (bm <= 16*MT) by 8/MT warps along N; a warp takes every
//     (8/MT)-th n8 tile, so that the two live n8 tiles of a 12-filter group
//     go to two warps where an m16 row has several. The f32 products run
//     two n8 tiles by up to two K steps at a time as straight-line code:
//     their 3xTF32 chains are independent, and the scheduler overlaps them.
//   * the window is staged once per block with ALL Cp channels in the
//     operand's type (cp.async in 16-byte chunks where aligned), so a live
//     step stages no activation. Each pixel's channels are padded to an odd
//     number of 16-byte groups where that fits: with a pitch of 32 or 64
//     f32 channels every lane of an A-fragment load would hit one bank.
//     Where all channels do not fit, the block restages the (rows, cols,
//     cpk) slice per live step (the slow path of huge windows, as in the
//     int8 instance).
//   * weights move through a ring of cp.async units, three deep, one
//     barrier per unit; the first unit is requested with the window. A unit
//     is 17 KB: 32 rows of f32 or 64 of bf16, i.e. whole K-tiles (two of the
//     unpacked 3x3 layout's 16-row tiles) or a part of a deeper one. The
//     ring IS the B operand: rows keep the tile's N-contiguous layout at a
//     pitch of kMaxBn + 8 elements, and the tf32 B-fragment loads (k = lane
//     % 4 (+4), n = lane / 4) fall on 32 distinct banks (136k + n = 8k + n
//     mod 32) with no transpose. bf16 wants two K-adjacent values in a word:
//     two 2-byte loads and one byte permute per register (68 words a row:
//     8t + n/2 mod 32, again conflict-free). Each thread reads back the
//     chunks it copied to note the unit's nonzero n8 tiles (no barrier
//     between copy and scan). Only lanes below bn are copied; rows past bk
//     are zeroed (a stale NaN there would reach every lane). The slow path
//     uses units of one K step, two deep, so that it needs under 16 KB
//     beside the window.
//   * A fragments are gathered in registers from the staged window through
//     the per-block K index -> window offset table, and split there.
//   * one block per (M-block, N-tile), the column's live tiles in ascending
//     order, no split-K, no atomics on data: two launches are bit-identical.
//   * the flush runs the shared `flush_epilogue`, two adjacent columns per
//     store (f32 or bf16 pairs); the n8 tiles whose weights are zero in
//     every unit hold the epilogue of a zero accumulator, written from a
//     precomputed row in 16-byte stores.
//   Shared memory with all channels: 3 x 17 KB of ring, the window (at most
//   45 KB of padded f32 pixels on the CIFAR net's layers) and the K table,
//   under 113 KB, so two blocks share an SM. Skipping zero weights assumes finite
//   activations: a NaN or Inf meets a skipped zero weight only where the
//   plain version gives NaN.
#include "cp_async.cuh"
#include "epilogue.cuh"
#include "mma_f32.cuh"
#include "mma_s8.cuh"

namespace hapm {

constexpr int kMaxSharedBytes = 232448;  // 227 KB a block may use on sm_90

struct ConvGeom {
  int Hp, Wp, Cp;         // padded input (B, Hp, Wp, Cp)
  int n_total, max_nnz;   // packed output columns, idx row length
  int kx, ky, stride;
  int block_oh, block_ow, spi, bpi;
  int bm, bk, bn, cpk, slot;
  int rows, cols;         // window shape
  int dsb;                // skip all-zero windows (int8 codes only)
  int full;               // window staged with all Cp channels once
  int vec;                // bytes per window copy (16, 8, 4 or 1)
  int wvec;               // weight rows copied 4 bytes (int8) / 16 bytes (float) at a time
  int wpitch;             // float, int8 resident: bytes per window pixel in shared memory
  int n_mb;               // M-blocks of the launch (B * bpi)
  int resident;           // int8: the resident path (weights held, M-blocks walked)
  int stage_out;          // int8 resident: int8 codes out, rows written 16 bytes a store
  int compact;            // int8: compacted K operands (each column's tap rows, a table)
  int kpad;               // compact: rows of the compacted weight and of each column's table
};

// ---------------------------------------------------------------------------
// int8 codes: tensor-core products (mma.sync), staged int8 operands
// ---------------------------------------------------------------------------

constexpr int kImmaThreads = 256;                 // 8 warps; two blocks an SM
constexpr int kImmaWarps = kImmaThreads / 32;
constexpr int kUnitK = 128;                       // weight rows per pipeline unit
constexpr int kUnitWordRows = kUnitK / 4;         // packed word rows per unit
constexpr int kBPitch = kMaxBn + 8;               // words per packed row, = 8 mod 32
constexpr int kBufWords = kUnitWordRows * kBPitch;
constexpr int kWBlocks = kUnitWordRows * (kMaxBn / 4) / kImmaThreads;  // 4x4 blocks a thread moves
constexpr int kStages = 3;                        // weight units in flight (raw ring)
// static shared memory: the epilogue rows, the zero-accumulator row (f32
// and codes) and three n8 masks
constexpr int kImmaStaticBytes = 4 * kMaxBn * 4 + kMaxBn + 16;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// A pipeline unit is up to `unit` weight rows (int8: 128): unit / bkk whole
// K-tiles (bkk = bk rounded up to the K step, 16 for int8) when the window
// holds all channels, else one K-tile, or one `unit`-row part of a K-tile
// deeper than that.
struct UnitShape {
  int upt, tpu, rows;  // units per K-tile, K-tiles per unit, rows of a full unit
};

__host__ __device__ inline UnitShape unit_shape_of(int bkk, int unit, int full) {
  UnitShape x;
  x.upt = (bkk + unit - 1) / unit;
  x.tpu = (full && x.upt == 1) ? unit / bkk : 1;
  x.rows = bkk * x.tpu < unit ? bkk * x.tpu : unit;
  return x;
}

__host__ __device__ inline UnitShape unit_shape(const ConvGeom& g, int full) {
  return unit_shape_of((g.bk + 15) / 16 * 16, kUnitK, full);
}

// Unit u of the run list: entries [s0, s0 + ns), rows [lo, lo + rt) of each.
struct Unit {
  int s0, ns, lo, rt;
};

__device__ __forceinline__ Unit unit_at(int u, const UnitShape& us, int bkk, int n_run) {
  Unit x;
  if (us.upt > 1) {
    x.s0 = u / us.upt;
    x.ns = 1;
    x.lo = (u % us.upt) * us.rows;
    x.rt = min(us.rows, bkk - x.lo);
  } else {
    x.s0 = u * us.tpu;
    x.ns = min(us.tpu, n_run - x.s0);
    x.lo = 0;
    x.rt = bkk;
  }
  return x;
}

// Byte offsets of the int8 kernel's dynamic shared memory: the two packed
// weight buffers, the raw ring of weight units in flight, the K index ->
// window offset table, the 16-row liveness flags, the column's live tiles,
// their nonzero flags and the list of those that run, and the window (all
// Cp channels when g.full, else one K-tile's cpk channels).
struct ImmaSmem {
  size_t raw, stage, woff, live16, lst, nz, run, win, total;
};

//
// On compacted K operands a raw unit carries its 128 table entries after
// its weight rows, the offset table holds two units' rows (one per packed
// buffer), and there are no step lists: nothing is skipped.
__host__ __device__ inline ImmaSmem imma_smem(const ConvGeom& g, int full) {
  const size_t bk16 = (g.bk + 15) / 16 * 16;
  const size_t lists = g.compact ? 0 : align16(static_cast<size_t>(g.max_nnz) * 4);
  ImmaSmem s;
  size_t o = static_cast<size_t>(2) * kBufWords * 4;
  s.raw = o;
  s.stage = g.compact ? static_cast<size_t>(kUnitK) * (kMaxBn + 4)
                      : static_cast<size_t>(unit_shape(g, full).rows) * kMaxBn;  // bytes of one raw unit
  o += kStages * s.stage;
  s.woff = o;
  o += g.compact ? 2 * kUnitK * 4 : align16(bk16 * 4);
  s.live16 = o;
  o += g.compact ? 0 : align16(bk16 / 16 * 4);
  s.lst = o;
  o += lists;
  s.nz = o;
  o += lists;
  s.run = o;
  o += lists;
  s.win = o;
  o += align16(static_cast<size_t>(g.rows) * g.cols * (full ? g.Cp : g.cpk));
  s.total = o;
  return s;
}

// Copy `rows` window rows of `segs` runs of `len` contiguous bytes each
// (run s of row r starts at src_row(r) + s*Cp) into win, run after run
// `dpitch` bytes apart, V bytes a copy.
template <int V>
__device__ __forceinline__ void copy_window(int8_t* win, const int8_t* src, size_t row_pitch,
                                            int rows, int segs, int len, int Cp, int dpitch,
                                            int tid) {
  const int per_seg = len / V;
  const int per_row = segs * per_seg;
  for (int e = tid; e < rows * per_row; e += kImmaThreads) {
    const int r = e / per_row;
    const int rem = e - r * per_row;
    const int s = rem / per_seg;
    const int o = (rem - s * per_seg) * V;
    const int8_t* from = src + r * row_pitch + static_cast<size_t>(s) * Cp + o;
    int8_t* to = win + (static_cast<size_t>(r) * segs + s) * dpitch + o;
    if constexpr (V == 1) {
      *to = *from;
    } else {
      cp_async<V>(to, from);
    }
  }
}

// Request channels [c_lo, c_lo + wc) of the M-block's window, elements of
// ES bytes, pixel after pixel `px_pitch` bytes apart in win (cp.async, or
// plain byte copies where no 4-byte chunk is aligned); when wc == Cp and
// the pixels are packed (px_pitch == Cp*ES) each window row is one
// contiguous run of cols*Cp elements. The caller waits.
template <int ES>
__device__ __forceinline__ void load_window(int8_t* win, const int8_t* __restrict__ xp,
                                             const ConvGeom& g, int b, int r0, int q0, int c_lo,
                                             int wc, int px_pitch, int tid) {
  const int8_t* src =
      xp + (((static_cast<size_t>(b) * g.Hp + r0) * g.Wp + q0) * g.Cp + c_lo) * ES;
  const size_t pitch = static_cast<size_t>(g.Wp) * g.Cp * ES;
  const bool whole = wc == g.Cp && px_pitch == g.Cp * ES;
  const int segs = whole ? 1 : g.cols;
  const int len = (whole ? g.cols * g.Cp : wc) * ES;
  const int dpitch = whole ? len : px_pitch;
  const int seg_pitch = g.Cp * ES;
  switch (g.vec) {
    case 16: copy_window<16>(win, src, pitch, g.rows, segs, len, seg_pitch, dpitch, tid); break;
    case 8: copy_window<8>(win, src, pitch, g.rows, segs, len, seg_pitch, dpitch, tid); break;
    case 4: copy_window<4>(win, src, pitch, g.rows, segs, len, seg_pitch, dpitch, tid); break;
    default: copy_window<1>(win, src, pitch, g.rows, segs, len, seg_pitch, dpitch, tid);
  }
}

// Copy one 4x4-byte block of the weight into its 16 bytes of a raw stage
// (row r of the block at byte 4r): rows p, p + n_total, ... (those below
// `rows_in`), lanes n .. n + 3 of the column (those below bn); zeros
// elsewhere.
__device__ __forceinline__ void copy_block(int8_t* dst, const int8_t* p, const ConvGeom& g,
                                           int rows_in, int n) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = r < rows_in && n < g.bn;
    if (in && g.wvec) {
      cp_async<4>(dst + 4 * r, p + static_cast<size_t>(r) * g.n_total);
    } else {
      int v = 0;
      if (in)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < g.bn)
            v |= static_cast<int>(static_cast<uint8_t>(p[r * g.n_total + c])) << (8 * c);
      *reinterpret_cast<int*>(dst + 4 * r) = v;
    }
  }
}

// Copy this thread's 4x4-byte blocks of unit x (K-tiles list[x.s0 ..], rows
// [x.lo, x.lo + x.rt) of each, columns [j*bn, j*bn + bn)) into its 16 bytes
// per block of a raw stage; zero past bk and bn. Only the thread that
// copies a block reads it back (convert_unit), so the copy needs no
// barrier, only cp.async.wait_group.
__device__ __forceinline__ void load_unit(int8_t* stage, const int8_t* __restrict__ w,
                                           const ConvGeom& g, int j, const int* list, Unit x,
                                           int tid) {
#pragma unroll
  for (int q = 0; q < kWBlocks; ++q) {
    const int blk = tid + kImmaThreads * q;
    const int kb = blk / (kMaxBn / 4);
    if (kb * 4 >= x.ns * x.rt) break;
    const int slot = kb * 4 / x.rt;
    const int k = x.lo + kb * 4 - slot * x.rt;
    const int tile = min(max(list[x.s0 + slot], 0), g.Cp / g.cpk - 1);  // in range if unused
    const int n = (blk % (kMaxBn / 4)) * 4;
    copy_block(stage + blk * 16,
               w + (static_cast<size_t>(tile) * g.bk + k) * g.n_total + j * g.bn + n, g,
               g.bk - k, n);
  }
}

// Compacted K operands: copy rows [k0, k0 + rt) of column j's compacted
// weight (rt a multiple of 32) as load_unit does, and, where `tab` is
// given, the unit's 128 table entries after the stage's kUnitK * kMaxBn
// weight bytes (threads 0..31, 16 bytes each; the entries past the
// column's rows are -1). Each thread reads back only what it copied.
__device__ __forceinline__ void load_rows(int8_t* stage, const int8_t* __restrict__ w,
                                          const int* __restrict__ tab, const ConvGeom& g, int j,
                                          int k0, int rt, int tid) {
#pragma unroll
  for (int q = 0; q < kWBlocks; ++q) {
    const int blk = tid + kImmaThreads * q;
    const int kb = blk / (kMaxBn / 4);
    if (kb * 4 >= rt) break;
    const int n = (blk % (kMaxBn / 4)) * 4;
    copy_block(stage + blk * 16,
               w + static_cast<size_t>(k0 + kb * 4) * g.n_total + j * g.bn + n, g, 4, n);
  }
  if (tab != nullptr && tid < kUnitK / 4)
    cp_async<16>(stage + kUnitK * kMaxBn + 16 * tid,
                 tab + static_cast<size_t>(j) * g.kpad + k0 + 4 * tid);
}

// A compacted row's window offset: its table entry (channel << 16 | dy << 8
// | dx) at `pitch` bytes a window pixel, -1 for a padding row.
__device__ __forceinline__ int tap_offset(int e, int cols, int pitch) {
  return e < 0 ? -1 : (((e >> 8) & 0xff) * cols + (e & 0xff)) * pitch + (e >> 16);
}

// The window offsets of a landed compacted unit's rows, from the table
// entries its threads 0..31 copied (load_rows), into woff[0 .. 128).
__device__ __forceinline__ void unit_offsets(const int8_t* stage, int* woff, const ConvGeom& g,
                                             int pitch, int tid) {
  if (tid < kUnitK / 4) {
    const int4 e = *reinterpret_cast<const int4*>(stage + kUnitK * kMaxBn + 16 * tid);
    *reinterpret_cast<int4*>(woff + 4 * tid) =
        make_int4(tap_offset(e.x, g.cols, pitch), tap_offset(e.y, g.cols, pitch),
                  tap_offset(e.z, g.cols, pitch), tap_offset(e.w, g.cols, pitch));
  }
}

// Transpose each of this thread's 4x4 blocks among the first `rows` rows of
// a landed raw stage (4 rows of 4 column bytes) into 4 words of 4
// K-consecutive codes (lowest K in the lowest byte) and store them into a
// packed buffer; OR into *n8_mask the n8 tiles (8-column groups) that hold a
// nonzero code.
__device__ __forceinline__ void convert_unit(const int8_t* stage, int* buf, unsigned* n8_mask,
                                             int rows, int tid) {
#pragma unroll
  for (int q = 0; q < kWBlocks; ++q) {
    const int blk = tid + kImmaThreads * q;
    const int kw = blk / (kMaxBn / 4);
    if (kw * 4 >= rows) break;
    const int n = (blk % (kMaxBn / 4)) * 4;
    const int4 v = transpose4x4_s8(*reinterpret_cast<const int4*>(stage + blk * 16));
    *reinterpret_cast<int4*>(buf + kw * kBPitch + n) = v;
    // a warp's 32 blocks share one word row and span all 16 n8 tiles
    const unsigned m = __reduce_or_sync(0xffffffffu, (v.x | v.y | v.z | v.w) ? 1u << (n / 8) : 0u);
    if ((tid & 31) == 0 && m != 0) atomicOr(n8_mask, m);
  }
}

// Four codes of one patch row: win[off + wo.{x,y,z,w}], zero where the
// table marks padding (-1) or the row is past the block's pixels.
__device__ __forceinline__ int gather4(const int8_t* win, bool valid, int off, int4 wo) {
  if (!valid) return 0;
  const int8_t* p = win + off;
  const unsigned b0 = wo.x >= 0 ? static_cast<uint8_t>(p[wo.x]) : 0u;
  const unsigned b1 = wo.y >= 0 ? static_cast<uint8_t>(p[wo.y]) : 0u;
  const unsigned b2 = wo.z >= 0 ? static_cast<uint8_t>(p[wo.z]) : 0u;
  const unsigned b3 = wo.w >= 0 ? static_cast<uint8_t>(p[wo.w]) : 0u;
  return static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// The int8 instance's flush of M-block i from the fragments. The n8 tiles
// whose weights are zero in every unit (no bit in any_n8) hold the
// zero-accumulator row in every row: where the output rows allow 16-byte
// stores, the block writes them from s_z / s_z8 (16 codes or 4 floats a
// store); every other tile goes through the fragments: rows gq and gq + 8,
// columns 2*tq and 2*tq + 1 of each n8 tile (the warp's tiles nt0, nt0 +
// STEP, ...).
template <int NTW, int STEP>
__device__ __forceinline__ void imma_flush_frags(const int (&acc)[NTW][4], const Epilogue& eps,
                                                 void* out, int out_int8, const ConvGeom& g, int i,
                                                 int j, unsigned any_n8, const float* s_z,
                                                 const int8_t* s_z8, int mt, int nt0, int gq,
                                                 int tq, int tid) {
  const int n8_count = (g.bn + 7) / 8;
  const unsigned dead = ~any_n8 & ((1u << n8_count) - 1u);
  unsigned skip = 0;
  if (out_int8 ? (g.bn % 16 == 0 && g.n_total % 16 == 0) : (g.bn % 4 == 0 && g.n_total % 4 == 0))
    skip = out_int8 ? ((dead & (dead >> 1)) & 0x5555u) * 3u : dead;
  if (skip != 0) {
    const int per = out_int8 ? g.bn / 16 : g.bn / 4;  // 16-byte chunks per row
    for (int e = tid; e < g.bm * per; e += kImmaThreads) {
      const int r = e / per;
      const int ch = e - r * per;
      if (!((skip >> (out_int8 ? 2 * ch : ch / 2)) & 1u)) continue;
      const size_t o = (static_cast<size_t>(i) * g.bm + r) * g.n_total + j * g.bn;
      if (out_int8) {
        *reinterpret_cast<int4*>(static_cast<int8_t*>(out) + o + 16 * ch) =
            *reinterpret_cast<const int4*>(s_z8 + 16 * ch);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o + 4 * ch) =
            *reinterpret_cast<const float4*>(s_z + 4 * ch);
      }
    }
  }

  const size_t row0 = (static_cast<size_t>(i) * g.bm + mt * 16 + gq) * g.n_total + j * g.bn;
  const int rows_left = g.bm - (mt * 16 + gq);  // rows gq (+8) exist while > 0 (> 8)
  if (out_int8) {
    flush_frags<kOutI8, NTW, STEP>(acc, eps, out, row0, g.n_total, rows_left, nt0 * 8 + 2 * tq,
                                   g.bn, skip >> nt0);
  } else {
    flush_frags<kOutF32, NTW, STEP>(acc, eps, out, row0, g.n_total, rows_left, nt0 * 8 + 2 * tq,
                                    g.bn, skip >> nt0);
  }
}

// The per-block body: one block per (M-block i, N-tile j), the column's
// weight units streamed through the raw ring for this M-block alone. On
// compacted K operands (kCompact) unit u is rows [128u, 128u + 128) of the
// column's krows[j] rows, which carries its table entries; its window
// offsets are formed when it is converted, beside its packed buffer.
template <int MT, bool kCompact>
__device__ __forceinline__ void imma_per_block(const int8_t* __restrict__ xp,
                                               const int8_t* __restrict__ w,
                                               const int* __restrict__ idx,
                                               const int* __restrict__ cnt, const Epilogue& ep,
                                               void* __restrict__ out, int out_int8,
                                               int* __restrict__ skips,
                                               const int* __restrict__ ktab,
                                               const int* __restrict__ krows, const ConvGeom& g) {
  constexpr int WN = kImmaWarps / MT;  // warps along N per m16 tile
  constexpr int NTW = 16 / WN;  // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned s_n8[3];                  // per packed unit: n8 tiles with a nonzero code
  __shared__ float s_rows[3][kMaxBn];           // this column's scale, bias, out_scale
  __shared__ __align__(16) float s_z[kMaxBn];   // epilogue of a zero accumulator
  __shared__ __align__(16) int8_t s_z8[kMaxBn];  // the same as int8 codes
  const ImmaSmem L = imma_smem(g, g.full);
  const UnitShape us = unit_shape(g, g.full);
  int* bufs = reinterpret_cast<int*>(smem_raw);
  int8_t* raw = reinterpret_cast<int8_t*>(smem_raw + L.raw);
  int* woff = reinterpret_cast<int*>(smem_raw + L.woff);
  int* live16 = reinterpret_cast<int*>(smem_raw + L.live16);
  int* lst = reinterpret_cast<int*>(smem_raw + L.lst);
  int* nz = reinterpret_cast<int*>(smem_raw + L.nz);
  int* run = reinterpret_cast<int*>(smem_raw + L.run);
  int8_t* win = reinterpret_cast<int8_t*>(smem_raw + L.win);

  const int n_cols = g.n_total / g.bn;
  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // mma groupID
  const int tq = lane & 3;   // mma thread in group

  const int b = i / g.bpi;
  const int p = i % g.bpi;
  const int r0 = (p / g.spi) * g.block_oh * g.stride;
  const int q0 = (p % g.spi) * g.block_ow * g.stride;
  const int n_pix = g.block_oh * g.block_ow;
  const int kxky = g.kx * g.ky;
  const int wc = g.full ? g.Cp : g.cpk;  // window bytes per pixel
  const int bk16 = (g.bk + 15) / 16 * 16;
  const int live = cnt[j];
  const int* idx_j = idx + static_cast<size_t>(j) * g.max_nnz;
  const bool skip_list = g.full && g.dsb;
  const int nrows = kCompact ? krows[j] : 0;  // compacted: the column's rows
  // rows of compacted unit u
  auto rows_of = [&](int u) { return min(kUnitK, nrows - u * kUnitK); };

  // requested first, in flight together: the window (all channels), the
  // weights of the column's first unit of tiles (from the table's first
  // entries, read beside the live count), the tile list and the epilogue
  // rows; an empty column stages nothing
  int first[kUnitK / 16];
#pragma unroll
  for (int q = 0; q < kUnitK / 16; ++q) first[q] = q < us.tpu && q < g.max_nnz ? idx_j[q] : 0;
  if (live > 0) {
    if (g.full) load_window<1>(win, xp, g, b, r0, q0, 0, g.Cp, g.Cp, tid);
    if constexpr (kCompact)
      load_rows(raw, w, ktab, g, j, 0, rows_of(0), tid);
    else
      load_unit(raw, w, g, j, first, unit_at(0, us, bk16, min(live, us.tpu)), tid);
  }
  if constexpr (!kCompact)
    for (int s = tid; s < live; s += kImmaThreads) lst[s] = idx_j[s];
  for (int c = tid; c < g.bn; c += kImmaThreads) {
    const int n = j * g.bn + c;
    s_rows[0][c] = ep.scale != nullptr ? ep.scale[n] : 0.0f;
    s_rows[1][c] = ep.bias != nullptr ? ep.bias[n] : 0.0f;
    s_rows[2][c] = ep.out_scale != nullptr ? ep.out_scale[n] : 0.0f;
  }
  // K index -> window offset of its (channel, tap), -1 on patch padding;
  // which 16-row K groups hold any real row (compacted: formed per unit)
  for (int k0 = 0; k0 < (kCompact ? 0 : bk16); k0 += kImmaThreads) {
    const int k = k0 + tid;
    int wo = -1;
    if (k < bk16) {
      const int ch = k / g.slot;
      const int tap = k - ch * g.slot;
      if (k < g.bk && tap < kxky && ch < g.cpk)
        wo = ((tap / g.ky) * g.cols + (tap % g.ky)) * wc + ch;
      woff[k] = wo;
    }
    const unsigned m = __ballot_sync(0xffffffffu, wo >= 0);
    if (lane == 0 && k < bk16) {
      live16[k / 16] = (m & 0xffffu) != 0;
      if (k + 16 < bk16) live16[k / 16 + 1] = (m >> 16) != 0;
    }
  }
  if (tid < 3) s_n8[tid] = 0;
  cp_async_wait_all();
  __syncthreads();

  // the epilogue on this column's rows in shared memory, and its value on a
  // zero accumulator (the output of every n8 tile no product reaches)
  const Epilogue eps{ep.scale != nullptr ? s_rows[0] : nullptr,
                     ep.bias != nullptr ? s_rows[1] : nullptr,
                     ep.out_scale != nullptr ? s_rows[2] : nullptr, ep.relu};
  for (int c = tid; c < g.bn; c += kImmaThreads) {
    const float z = flush_epilogue<int>(0, eps, c);
    s_z[c] = z;
    s_z8[c] = ep.out_scale != nullptr ? static_cast<int8_t>(z) : 0;
  }

  int n_run = live;
  if (skip_list && live > 0) {
    // skip flag of every live step from the staged window (the whole window
    // of its K-tile's cpk channels), one warp per step; then every warp
    // forms the same list of the steps that run, in ascending order
    const int slice = g.rows * g.cols * g.cpk;
    for (int s = warp; s < live; s += kImmaWarps) {
      const int cb = lst[s] * g.cpk;
      int hit = 0;
      for (int e0 = 0; e0 < slice; e0 += 32) {
        const int e = e0 + lane;
        if (e < slice) {
          const int px = e / g.cpk;
          hit |= win[px * wc + cb + (e - px * g.cpk)] != 0;
        }
        if (__any_sync(0xffffffffu, hit)) {
          hit = 1;
          break;
        }
      }
      if (lane == 0) nz[s] = hit;
    }
    __syncthreads();
    n_run = 0;
    for (int s0 = 0; s0 < live; s0 += 32) {
      const int s = s0 + lane;
      const bool keep = s < live && nz[s] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) run[n_run + __popc(m & ((1u << lane) - 1u))] = lst[s];  // same in every warp
      n_run += __popc(m);
    }
    __syncwarp();
  }
  if (!skip_list) run = lst;
  int skipped = live - n_run;
  const int n_units = kCompact ? (nrows + kUnitK - 1) / kUnitK
                      : us.upt > 1 ? n_run * us.upt : (n_run + us.tpu - 1) / us.tpu;

  // output rows of this thread's two fragment rows, and their window offsets
  const int mt = warp / WN;
  const int nt0 = (warp % WN) * NTW;
  bool valid[2];
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + gq + 8 * h;
    valid[h] = m < n_pix;
    const int oh = m / g.block_ow;
    const int ow = m % g.block_ow;
    off[h] = valid[h] ? ((oh * g.stride) * g.cols + ow * g.stride) * wc : 0;
  }
  // a K-tile of one 16- or 32-deep step (bk16 = 16 or 32) reads the same
  // table entries at every step
  int4 h_wa = make_int4(-1, -1, -1, -1), h_wb = h_wa;
  bool h_live = false;
  if constexpr (!kCompact) {
    h_wa = *reinterpret_cast<const int4*>(woff + 4 * tq);
    if (bk16 >= 32) h_wb = *reinterpret_cast<const int4*>(woff + 16 + 4 * tq);
    h_live = bk16 == 16 ? live16[0] != 0 : (bk16 == 32 && (live16[0] | live16[1]));
  }

  int acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0;

  // weight pipeline: unit u sits in raw stage u % kStages; units 1 ..
  // kStages-1 are requested now (one cp.async group each, empty past the
  // last unit), unit 0 has landed (requested from the table's first entries
  // before the skips were known; again if a skip changed them)
  auto request_unit = [&](int8_t* stage, int v) {
    if constexpr (kCompact)
      load_rows(stage, w, ktab, g, j, v * kUnitK, rows_of(v), tid);
    else
      load_unit(stage, w, g, j, run, unit_at(v, us, bk16, n_run), tid);
  };
  // a landed unit into packed buffer u & 1 (compacted: its window offsets
  // beside it)
  auto convert = [&](const int8_t* stage, int u) {
    if constexpr (kCompact) {
      convert_unit(stage, bufs + (u & 1) * kBufWords, &s_n8[u % 3], rows_of(u), tid);
      unit_offsets(stage, woff + (u & 1) * kUnitK, g, g.Cp, tid);
    } else {
      const Unit x = unit_at(u, us, bk16, n_run);
      convert_unit(stage, bufs + (u & 1) * kBufWords, &s_n8[u % 3], x.ns * x.rt, tid);
    }
  };
  if (n_units > 0) {
    if constexpr (!kCompact) {
      const Unit x0 = unit_at(0, us, bk16, n_run);
      bool same = true;
      if (skip_list)
        for (int q = 0; q < x0.ns; ++q) same &= nz[q] != 0;
      if (!same) {
        load_unit(raw, w, g, j, run, x0, tid);
        cp_async_wait_all();
      }
    }
    convert(raw, 0);
  }
#pragma unroll
  for (int v = 1; v < kStages; ++v) {
    if (v < n_units) request_unit(raw + v * L.stage, v);
    cp_async_commit();
  }
  __syncthreads();

  auto step32 = [&](const int* buf, int kw, unsigned n8, const int8_t* wn, int4 wa, int4 wb) {
    const int n_hi = 32 - __clz(n8 & ((1u << NTW) - 1u));
    const int a0 = gather4(wn, valid[0], off[0], wa);
    const int a1 = gather4(wn, valid[1], off[1], wa);
    const int a2 = gather4(wn, valid[0], off[0], wb);
    const int a3 = gather4(wn, valid[1], off[1], wb);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int col = (nt0 + n) * 8 + gq;
      if (n >= n_hi) break;
      mma_k32(acc[n], a0, a1, a2, a3, buf[kw * kBPitch + col], buf[(kw + 4) * kBPitch + col]);
    }
  };
  auto step16 = [&](const int* buf, int kw, unsigned n8, const int8_t* wn, int4 wa) {
    const int n_hi = 32 - __clz(n8 & ((1u << NTW) - 1u));
    const int a0 = gather4(wn, valid[0], off[0], wa);
    const int a1 = gather4(wn, valid[1], off[1], wa);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int col = (nt0 + n) * 8 + gq;
      if (n >= n_hi) break;
      mma_k16(acc[n], a0, a1, buf[kw * kBPitch + col]);
    }
  };

  unsigned any_n8 = 0;  // n8 tiles whose weights hold a nonzero code
  bool tile_on = true;
  for (int u = 0; u < n_units; ++u) {
    const Unit x = kCompact ? Unit{0, 1, u * kUnitK, rows_of(u)} : unit_at(u, us, bk16, n_run);
    if (!kCompact && !g.full && x.lo == 0) {
      // slow path (one K-tile per unit): this step's (rows, cols, cpk)
      // window, and its skip
      load_window<1>(win, xp, g, b, r0, q0, run[x.s0] * g.cpk, g.cpk, g.cpk, tid);
      cp_async_wait_all();
      __syncthreads();
      if (g.dsb) {
        int hit = 0;
        const int slice = g.rows * g.cols * g.cpk;
        for (int e = tid; e < slice && !hit; e += kImmaThreads) hit = win[e] != 0;
        tile_on = __syncthreads_or(hit) != 0;
        skipped += tile_on ? 0 : 1;
      }
    }
    // products only up to the last n8 tile whose weights hold a nonzero code
    // (lane padding multiplies zeros); a unit's mask is cleared two units
    // before it is written again
    const unsigned n8_unit = s_n8[u % 3];
    const unsigned n8 = n8_unit >> nt0;
    if (tid == 0) s_n8[(u + 2) % 3] = 0;
    any_n8 |= n8_unit;
    if (kCompact && (n8 & ((1u << NTW) - 1u)) != 0) {
      // the unit's rows against their window offsets, each a real tap of
      // some channel (a whole unit: four K steps in straight-line code)
      const int* buf = bufs + (u & 1) * kBufWords;
      const int* wo = woff + (u & 1) * kUnitK;
      if (x.rt == kUnitK) {
#pragma unroll
        for (int d = 0; d < kUnitK; d += 32)
          step32(buf, d / 4 + tq, n8, win, *reinterpret_cast<const int4*>(wo + d + 4 * tq),
                 *reinterpret_cast<const int4*>(wo + d + 16 + 4 * tq));
      } else {
        for (int d = 0; d < x.rt; d += 32)
          step32(buf, d / 4 + tq, n8, win, *reinterpret_cast<const int4*>(wo + d + 4 * tq),
                 *reinterpret_cast<const int4*>(wo + d + 16 + 4 * tq));
      }
    } else if (!kCompact && tile_on && (n8 & ((1u << NTW) - 1u)) != 0) {
      const int* buf = bufs + (u & 1) * kBufWords;
      for (int q = 0; q < x.ns; ++q) {
        const int8_t* wn = win + (g.full ? run[x.s0 + q] * g.cpk : 0);
        const int kq = q * x.rt;  // the K-tile's first row in the unit
        if (bk16 == 16) {
          if (h_live) step16(buf, kq / 4 + tq, n8, wn, h_wa);
        } else if (bk16 == 32) {
          if (h_live) step32(buf, kq / 4 + tq, n8, wn, h_wa, h_wb);
        } else {
          for (int k = x.lo; k < x.lo + x.rt;) {
            const int kw = (kq + k - x.lo) / 4 + tq;
            if (x.lo + x.rt - k >= 32) {
              if (live16[k / 16] | live16[k / 16 + 1])
                step32(buf, kw, n8, wn, *reinterpret_cast<const int4*>(woff + k + 4 * tq),
                       *reinterpret_cast<const int4*>(woff + k + 16 + 4 * tq));
              k += 32;
            } else {
              if (live16[k / 16])
                step16(buf, kw, n8, wn, *reinterpret_cast<const int4*>(woff + k + 4 * tq));
              k += 16;
            }
          }
        }
      }
    }
    if (u + 1 < n_units) {
      // unit u+1 has landed (all but the newest kStages-2 groups); the
      // packed buffer it goes to (and its offsets) was last read by unit
      // u-1, which every warp finished before the barrier one iteration ago
      cp_async_wait<kStages - 2>();
      convert(raw + ((u + 1) % kStages) * L.stage, u + 1);
    }
    const int v = u + kStages;  // into the raw stage unit u has left
    if (v < n_units) request_unit(raw + (u % kStages) * L.stage, v);
    cp_async_commit();
    __syncthreads();
  }
  if (skips != nullptr && tid == 0) skips[i * n_cols + j] = skipped;
  imma_flush_frags<NTW, 1>(acc, eps, out, out_int8, g, i, j, any_n8, s_z, s_z8, mt, nt0, gq, tq,
                           tid);
}

// ---------------------------------------------------------------------------
// int8 codes, resident path: weight-stationary blocks that walk M-blocks
// ---------------------------------------------------------------------------

constexpr int kWinRing = 2;             // M-block windows: the one in use, the next in flight
// bytes per staged row of output codes: 16 beside the 128 lanes, so that
// the fragments' 2-byte stores of rows gq = 0..7 fall in distinct banks
constexpr int kStagePitch = kMaxBn + 16;

// m16 tiles a block of the int8 instance holds for bm rows (its MT)
__host__ __device__ inline int imma_mt(int bm) {
  return bm <= 16 ? 1 : (bm <= 32 ? 2 : (bm <= 64 ? 4 : 8));
}

// Byte offsets of the resident kernel's dynamic shared memory: a packed
// buffer for each of the widest column's kpad / 128 compacted units, a
// window offset for each of their rows, the units' n8 masks, the staging
// rows of output codes (16 an m16 tile) and the ring of M-block windows
// (all Cp channels). `resident_smem_bytes` in kernels/implicit_conv.py
// counts the same.
struct ResSmem {
  int units;
  size_t woff, n8, stg, win, wstride, total;
};

__host__ __device__ inline ResSmem resident_smem(const ConvGeom& g) {
  ResSmem s;
  s.units = g.kpad / kUnitK;
  size_t o = static_cast<size_t>(s.units) * kBufWords * 4;
  s.woff = o;
  o += align16(static_cast<size_t>(g.kpad) * 4);
  s.n8 = o;
  o += align16(static_cast<size_t>(s.units) * 4);
  s.stg = o;
  o += static_cast<size_t>(imma_mt(g.bm)) * 16 * kStagePitch;
  s.win = o;
  s.wstride = align16(static_cast<size_t>(g.rows) * g.cols * g.wpitch);
  o += kWinRing * s.wstride;
  s.total = o;
  return s;
}

// Transpose a weight unit that landed raw at the start of its own packed
// buffer (load_unit's layout: a thread's 4x4 blocks at 16 bytes each) into
// that buffer: every thread reads its blocks among the first `rows` rows,
// then, after a barrier, writes them transposed; OR into *n8_mask the n8
// tiles that hold a nonzero code. Called by every thread of the block.
__device__ __forceinline__ void convert_in_place(int* buf, unsigned* n8_mask, int rows, int tid) {
  int4 v[kWBlocks];
#pragma unroll
  for (int q = 0; q < kWBlocks; ++q) {
    const int blk = tid + kImmaThreads * q;
    v[q] = blk / (kMaxBn / 4) * 4 < rows ? reinterpret_cast<const int4*>(buf)[blk]
                                         : make_int4(0, 0, 0, 0);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kWBlocks; ++q) {
    const int blk = tid + kImmaThreads * q;
    const int kw = blk / (kMaxBn / 4);
    if (kw * 4 >= rows) break;
    const int n = (blk % (kMaxBn / 4)) * 4;
    const int4 t = transpose4x4_s8(v[q]);
    *reinterpret_cast<int4*>(buf + kw * kBPitch + n) = t;
    const unsigned m = __reduce_or_sync(0xffffffffu, (t.x | t.y | t.z | t.w) ? 1u << (n / 8) : 0u);
    if ((tid & 31) == 0 && m != 0) atomicOr(n8_mask, m);
  }
}

// The resident body, on compacted K operands: block c of column j holds the
// column's krows[j] rows in 128-row units, converted once, with their window
// offsets formed once from its table, and walks M-blocks c, c + G, c + 2G,
// ... (G = gridDim.x). Each M-block's window (all channels) is requested one
// M-block ahead into a ring of two; its products run against the resident
// units, and its int8 codes leave through the staging rows of each m16 tile
// in 16-byte stores (f32 outputs, and rows that do not allow them, through
// the fragments). The WN warps of an m16 tile take every WN-th n8 tile, so
// that the live tiles at the front of a column (9 of 16 on a 64-channel
// conv) split evenly. Compacted launches skip no step: where `skips` is
// given, each (M-block, column) counts zero.
template <int MT>
__device__ __forceinline__ void imma_resident(const int8_t* __restrict__ xp,
                                              const int8_t* __restrict__ w,
                                              const int* __restrict__ cnt, const Epilogue& ep,
                                              void* __restrict__ out, int out_int8,
                                              int* __restrict__ skips,
                                              const int* __restrict__ ktab,
                                              const int* __restrict__ krows, const ConvGeom& g) {
  constexpr int WN = kImmaWarps / MT;  // warps along N per m16 tile
  constexpr int NTW = 16 / WN;         // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_rows[3][kMaxBn];            // this column's scale, bias, out_scale
  __shared__ __align__(16) float s_z[kMaxBn];    // epilogue of a zero accumulator
  __shared__ __align__(16) int8_t s_z8[kMaxBn];  // the same as int8 codes
  const ResSmem L = resident_smem(g);
  int* bufs = reinterpret_cast<int*>(smem_raw);
  int* woff = reinterpret_cast<int*>(smem_raw + L.woff);
  unsigned* n8s = reinterpret_cast<unsigned*>(smem_raw + L.n8);
  int8_t* wins = reinterpret_cast<int8_t*>(smem_raw + L.win);

  const int n_cols = g.n_total / g.bn;
  const int j = blockIdx.y;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // mma groupID
  const int tq = lane & 3;   // mma thread in group
  const int n_pix = g.block_oh * g.block_ow;
  const int live = cnt[j];
  const int nrows = krows[j];  // the column's rows
  auto rows_of = [&](int u) { return min(kUnitK, nrows - u * kUnitK); };
  const int n_units = (nrows + kUnitK - 1) / kUnitK;

  // one cp.async group: the window of M-block i into ring slot s (empty past
  // the last M-block, and for a column with no live tile)
  auto request = [&](int i, int s) {
    if (i < g.n_mb && live > 0) {
      const int p = i % g.bpi;
      load_window<1>(wins + s * L.wstride, xp, g, i / g.bpi, (p / g.spi) * g.block_oh * g.stride,
                     (p % g.spi) * g.block_ow * g.stride, 0, g.Cp, g.wpitch, tid);
    }
    cp_async_commit();
  };

  // once a block: every weight unit of the column (one group, each unit raw
  // in its own packed buffer), then the first window; beside them the
  // epilogue rows and the units' window offsets
  for (int u = 0; u < n_units; ++u)
    load_rows(reinterpret_cast<int8_t*>(bufs + u * kBufWords), w, nullptr, g, j, u * kUnitK,
              rows_of(u), tid);
  cp_async_commit();
  request(blockIdx.x, 0);
  for (int c = tid; c < g.bn; c += kImmaThreads) {
    const int n = j * g.bn + c;
    s_rows[0][c] = ep.scale != nullptr ? ep.scale[n] : 0.0f;
    s_rows[1][c] = ep.bias != nullptr ? ep.bias[n] : 0.0f;
    s_rows[2][c] = ep.out_scale != nullptr ? ep.out_scale[n] : 0.0f;
  }
  for (int k = tid; k < n_units * kUnitK; k += kImmaThreads)
    woff[k] = tap_offset(ktab[static_cast<size_t>(j) * g.kpad + k], g.cols, g.wpitch);
  for (int u = tid; u < n_units; u += kImmaThreads) n8s[u] = 0;
  cp_async_wait<1>();  // the weights (the first window may be in flight)
  __syncthreads();
  for (int u = 0; u < n_units; ++u) convert_in_place(bufs + u * kBufWords, &n8s[u], rows_of(u), tid);
  const Epilogue eps{ep.scale != nullptr ? s_rows[0] : nullptr,
                     ep.bias != nullptr ? s_rows[1] : nullptr,
                     ep.out_scale != nullptr ? s_rows[2] : nullptr, ep.relu};
  for (int c = tid; c < g.bn; c += kImmaThreads) {
    const float z = flush_epilogue<int>(0, eps, c);
    s_z[c] = z;
    s_z8[c] = ep.out_scale != nullptr ? static_cast<int8_t>(z) : 0;
  }
  __syncthreads();

  // n8 tiles whose weights hold a nonzero code in some unit: the tiles up
  // to the last such one are the only ones the fragments flush
  unsigned any_n8 = 0;
  for (int u = 0; u < n_units; ++u) any_n8 |= n8s[u];
  const int n_hi = 32 - __clz(any_n8);
  const int mt = warp / WN;
  const int nt0 = warp % WN;  // this warp's n8 tiles: nt0, nt0 + WN, ...
  int8_t* stg = reinterpret_cast<int8_t*>(smem_raw + L.stg) + mt * 16 * kStagePitch;
  // the staging rows hold the zero-accumulator codes in every lane no
  // fragment writes: the same for every M-block (the loop's first barrier
  // orders these stores before any read)
  if (g.stage_out)
    for (int e = tid; e < MT * 16 * (kMaxBn / 4); e += kImmaThreads) {
      const int r = e / (kMaxBn / 4);
      const int c4 = (e - r * (kMaxBn / 4)) * 4;
      *reinterpret_cast<int*>(smem_raw + L.stg + r * kStagePitch + c4) =
          *reinterpret_cast<const int*>(s_z8 + c4);
    }

  // output rows of this thread's two fragment rows, and their window offsets
  bool valid[2];
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + gq + 8 * h;
    valid[h] = m < n_pix;
    const int oh = m / g.block_ow;
    const int ow = m % g.block_ow;
    off[h] = valid[h] ? ((oh * g.stride) * g.cols + ow * g.stride) * g.wpitch : 0;
  }

  int acc[NTW][4];
  // one 32-deep K step of this warp's m16 tile against its n8 tiles below hi
  auto step32 = [&](const int* buf, int kw, int hi, const int8_t* wn, int4 wa, int4 wb) {
    const int a0 = gather4(wn, valid[0], off[0], wa);
    const int a1 = gather4(wn, valid[1], off[1], wa);
    const int a2 = gather4(wn, valid[0], off[0], wb);
    const int a3 = gather4(wn, valid[1], off[1], wb);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int nt = nt0 + n * WN;
      if (nt >= hi) break;
      mma_k32(acc[n], a0, a1, a2, a3, buf[kw * kBPitch + nt * 8 + gq],
              buf[(kw + 4) * kBPitch + nt * 8 + gq]);
    }
  };

  int t = 0;  // this block's M-blocks so far
  for (int i = blockIdx.x; i < g.n_mb; i += G, ++t) {
    // window i has landed; after the barrier every warp has left M-block
    // i - G, whose ring slot takes window i + G
    cp_async_wait<0>();
    __syncthreads();
    request(i + G, (t + 1) % kWinRing);
    const int8_t* win = wins + (t % kWinRing) * L.wstride;

#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0;
    for (int u = 0; u < n_units; ++u) {
      // products only up to the last n8 tile whose weights in the unit hold
      // a nonzero code (lane padding multiplies zeros); the unit's rows
      // against their window offsets, each a real tap of some channel (a
      // whole unit: four K steps in straight-line code)
      const int hi = 32 - __clz(n8s[u]);
      if (nt0 >= hi) continue;
      const int* buf = bufs + u * kBufWords;
      const int* wo = woff + u * kUnitK;
      const int rt = rows_of(u);
      if (rt == kUnitK) {
#pragma unroll
        for (int d = 0; d < kUnitK; d += 32)
          step32(buf, d / 4 + tq, hi, win, *reinterpret_cast<const int4*>(wo + d + 4 * tq),
                 *reinterpret_cast<const int4*>(wo + d + 16 + 4 * tq));
      } else {
        for (int d = 0; d < rt; d += 32)
          step32(buf, d / 4 + tq, hi, win, *reinterpret_cast<const int4*>(wo + d + 4 * tq),
                 *reinterpret_cast<const int4*>(wo + d + 16 + 4 * tq));
      }
    }
    if (skips != nullptr && tid == 0) skips[i * n_cols + j] = 0;

    if (!g.stage_out) {
      imma_flush_frags<NTW, WN>(acc, eps, out, out_int8, g, i, j, any_n8, s_z, s_z8, mt, nt0, gq,
                                tq, tid);
      continue;
    }
    // flush: this warp's fragments (columns 2*tq, 2*tq + 1 of its tiles
    // below n_hi, rows gq and gq + 8) into its m16 tile's staging rows as
    // codes; once the tile's WN warps are there (a named barrier, one per
    // m16 tile), its 16 rows go out in 16-byte stores
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int c = (nt0 + n * WN) * 8 + 2 * tq;
      if (c >= n_hi * 8) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = static_cast<int8_t>(flush_epilogue<int>(acc[n][2 * h], eps, c));
        const int v1 = static_cast<int8_t>(flush_epilogue<int>(acc[n][2 * h + 1], eps, c + 1));
        *reinterpret_cast<unsigned short*>(stg + (gq + 8 * h) * kStagePitch + c) =
            static_cast<unsigned short>((v0 & 0xff) | ((v1 & 0xff) << 8));
      }
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mt), "r"(WN * 32) : "memory");
    constexpr int CPR = kMaxBn / 16;  // 16-byte chunks of a staged row
    int8_t* out8 = static_cast<int8_t*>(out);
    for (int e = nt0 * 32 + lane; e < 16 * CPR; e += WN * 32) {
      const int r = e / CPR;
      const int col = 16 * (e - r * CPR);
      const int m = mt * 16 + r;
      if (m < g.bm && col < g.bn)
        *reinterpret_cast<int4*>(out8 + (static_cast<size_t>(i) * g.bm + m) * g.n_total +
                                 j * g.bn + col) =
            *reinterpret_cast<const int4*>(stg + r * kStagePitch + col);
    }
  }
}

template <int MT, bool kResident, bool kCompact>
__global__ void __launch_bounds__(kImmaThreads, 2)
implicit_conv_kernel_imma(const int8_t* __restrict__ xp, const int8_t* __restrict__ w,
                          const int* __restrict__ idx, const int* __restrict__ cnt, Epilogue ep,
                          void* __restrict__ out, int out_int8, int* __restrict__ skips,
                          const int* __restrict__ ktab, const int* __restrict__ krows,
                          ConvGeom g) {
  static_assert(kCompact || !kResident, "the resident body runs on compacted K operands only");
  if constexpr (kResident) {
    imma_resident<MT>(xp, w, cnt, ep, out, out_int8, skips, ktab, krows, g);
  } else {
    imma_per_block<MT, kCompact>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows, g);
  }
}

// ---------------------------------------------------------------------------
// f32 / bf16 operands: tensor-core products (3xTF32 / bf16 mma.sync)
// ---------------------------------------------------------------------------

constexpr int kFPitch = kMaxBn + 8;  // elements per weight row in the ring

// K rows per mma step (tf32 m16n8k8: 8, bf16 m16n8k16: 16) and weight rows
// per ring unit (17 KB of rows either way)
template <typename T>
__host__ __device__ constexpr int k_step() { return 32 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int unit_rows() { return 128 / static_cast<int>(sizeof(T)); }

// static shared memory of the float kernel: three n8 masks, the epilogue
// rows and the zero-accumulator row in the output type
template <typename T>
constexpr int kMmaStaticBytes = 16 + 3 * kMaxBn * 4 + kMaxBn * static_cast<int>(sizeof(T));

template <typename T>
__host__ __device__ inline UnitShape mma_units(const ConvGeom& g, int full) {
  constexpr int ks = k_step<T>();
  return unit_shape_of((g.bk + ks - 1) / ks * ks, full ? unit_rows<T>() : ks, full);
}

// Byte offsets of the float kernel's dynamic shared memory: the ring of
// weight units (three deep with all channels, else two units of one K step),
// the K index -> window offset table, the per-K-step liveness flags and the
// window (all Cp channels when `full`, else one K-tile's cpk channels).
struct MmaSmem {
  int stages;
  size_t stage, woff, live, win, total;  // stage = bytes of one unit
};

template <typename T>
__host__ __device__ inline MmaSmem mma_smem(const ConvGeom& g, int full) {
  constexpr int ks = k_step<T>();
  const size_t bkk = (g.bk + ks - 1) / ks * ks;
  MmaSmem s;
  s.stages = full ? 3 : 2;
  s.stage = static_cast<size_t>(mma_units<T>(g, full).rows) * kFPitch * sizeof(T);
  size_t o = s.stages * s.stage;
  s.woff = o;
  o += align16(bkk * 4);
  s.live = o;
  o += align16(bkk / ks * 4);
  s.win = o;
  o += align16(static_cast<size_t>(g.rows) * g.cols * g.wpitch);
  s.total = o;
  return s;
}

// Bytes per window pixel in shared memory for `bytes` of channels: padded
// to an odd number of 16-byte groups where `padded`, so that the pixels an
// A-fragment load touches start in different bank groups (with a pitch of
// 32 or 64 f32 channels every lane of a warp would hit one bank); narrow
// pixels stay packed, their words already spread over the banks.
__host__ __device__ inline int window_pitch(int bytes, int padded) {
  return padded && bytes >= 16 ? 16 * (((bytes + 15) / 16) | 1) : bytes;
}

template <typename T>
using Bits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;

// Request unit x of the weights (K-tiles list[x.s0 ..], rows [x.lo, x.lo +
// x.rt) of each, lanes [0, bn) of column j) into a ring stage, unit row r at
// r * kFPitch, in 16-byte chunks: cp.async where the rows allow it, else
// element copies. Rows past bk are zeros: their patch rows are padding, and
// a stale NaN there would reach every lane. Lanes past bn are not written;
// no output column reads them.
template <typename T>
__device__ __forceinline__ void load_wunit(T* stage, const T* __restrict__ w, const ConvGeom& g,
                                           int j, const int* __restrict__ list, Unit x,
                                           int tid) {
  constexpr int LPC = 16 / sizeof(T);  // lanes per chunk
  constexpr int CPR = kMaxBn / LPC;    // chunks per row
  for (int e = tid; e < x.ns * x.rt * CPR; e += kImmaThreads) {
    const int r = e / CPR;
    const int c = (e - r * CPR) * LPC;
    if (c >= g.bn) continue;
    const int slot = r / x.rt;
    const int k = x.lo + r - slot * x.rt;
    Bits<T>* dst = reinterpret_cast<Bits<T>*>(stage + r * kFPitch + c);
    if (k >= g.bk) {
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
      continue;
    }
    const Bits<T>* src = reinterpret_cast<const Bits<T>*>(w) +
                         (static_cast<size_t>(list[x.s0 + slot]) * g.bk + k) * g.n_total +
                         static_cast<size_t>(j) * g.bn + c;
    if (g.wvec) {
      cp_async<16>(dst, src);
    } else {
#pragma unroll
      for (int l = 0; l < LPC; ++l) dst[l] = c + l < g.bn ? src[l] : Bits<T>(0);
    }
  }
}

// OR into *n8_mask the n8 tiles (8-lane groups) of a landed unit of `rows`
// rows whose weights hold a nonzero value (-0 counts as zero), from the
// chunks this thread copied: a thread reads back only its own copies, so the
// scan needs cp.async.wait_group and no barrier.
template <typename T>
__device__ __forceinline__ void scan_wunit(const T* stage, const ConvGeom& g, int rows,
                                           unsigned* n8_mask, int tid) {
  constexpr int LPC = 16 / sizeof(T);
  constexpr int CPR = kMaxBn / LPC;
  constexpr unsigned kMagnitude = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  unsigned m = 0;
  for (int e = tid; e < rows * CPR; e += kImmaThreads) {
    const int r = e / CPR;
    const int c = (e - r * CPR) * LPC;
    if (c >= g.bn) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kFPitch + c);
    if (((v.x | v.y | v.z | v.w) & kMagnitude) != 0) m |= 1u << (c / 8);
  }
  m = __reduce_or_sync(0xffffffffu, m);
  if ((tid & 31) == 0 && m != 0) atomicOr(n8_mask, m);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// A fragment of one tf32 K step, split: window values at the step's K
// offsets wo[tq] and wo[tq + 4] (-1 = padding) for the thread's two rows.
__device__ __forceinline__ void gather_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* x,
                                            const int* wo, const bool (&valid)[2],
                                            const int (&off)[2], int tq) {
  const int ka = wo[tq];
  const int kb = wo[tq + 4];
  const float v[4] = {valid[0] && ka >= 0 ? x[off[0] + ka] : 0.0f,
                      valid[1] && ka >= 0 ? x[off[1] + ka] : 0.0f,
                      valid[0] && kb >= 0 ? x[off[0] + kb] : 0.0f,
                      valid[1] && kb >= 0 ? x[off[1] + kb] : 0.0f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Tf32Split sp = split_tf32(v[q]);
    hi[q] = sp.hi;
    lo[q] = sp.lo;
  }
}

// NS consecutive tf32 K steps (rows b, b + 8*kFPitch, ...; window offsets
// wo, wo + 8, ...) of a warp's m16 tile against its n8 tiles nt0, nt0 + WN,
// ... below n_hi, two tiles at a time without a branch between them: the
// 3xTF32 chains of different tiles and steps are independent (each step
// sums into its own fragment), so straight-line code lets the scheduler
// overlap their mma latencies. A tile past n_hi in a pair multiplies zero
// weights, or lanes past bn that no output column reads.
template <int NTW, int WN, int NS>
__device__ __forceinline__ void mma_steps_tf32(float (&acc)[NTW][4], const float* b,
                                               const float* x, const int* wo,
                                               const bool (&valid)[2], const int (&off)[2],
                                               int n_hi, int nt0, int gq, int tq) {
  constexpr int G = NTW < 2 ? NTW : 2;
  uint32_t hi[NS][4], lo[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) gather_tf32(hi[s], lo[s], x, wo + 8 * s, valid, off, tq);
#pragma unroll
  for (int n = 0; n < NTW; n += G) {
    if (nt0 + n * WN >= n_hi) break;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int col = (nt0 + (n + i) * WN) * 8 + gq;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float* bs = b + 8 * s * kFPitch + col;
        mma_3xtf32(acc[n + i], hi[s], lo[s], split_tf32(bs[tq * kFPitch]),
                   split_tf32(bs[(tq + 4) * kFPitch]));
      }
    }
  }
}

// One bf16 K step (16 rows) of a warp's m16 tile against its n8 tiles nt0,
// nt0 + WN, ... below n_hi whose bit in n8 is set: A gathered from the
// window through the offsets wo[0 .. 16) (-1 = padding), B from the unit's
// rows b at pitch kFPitch, two 2-byte loads per K pair.
template <int NTW, int WN>
__device__ __forceinline__ void mma_step_bf16(float (&acc)[NTW][4], const __nv_bfloat16* b,
                                              const __nv_bfloat16* wn, const int* wo,
                                              const bool (&valid)[2], const int (&off)[2],
                                              unsigned n8, int n_hi, int nt0, int gq, int tq) {
  const uint16_t* x = reinterpret_cast<const uint16_t*>(wn);
  const uint16_t* bh = reinterpret_cast<const uint16_t*>(b);
  const int2 ka = *reinterpret_cast<const int2*>(wo + 2 * tq);
  const int2 kb = *reinterpret_cast<const int2*>(wo + 2 * tq + 8);
  auto at = [&](int h, int k) -> uint16_t {
    return valid[h] && k >= 0 ? x[off[h] + k] : static_cast<uint16_t>(0);
  };
  const uint32_t a[4] = {pack_bf16(at(0, ka.x), at(0, ka.y)), pack_bf16(at(1, ka.x), at(1, ka.y)),
                         pack_bf16(at(0, kb.x), at(0, kb.y)), pack_bf16(at(1, kb.x), at(1, kb.y))};
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int nt = nt0 + n * WN;
    if (nt >= n_hi) break;
    if (!((n8 >> nt) & 1u)) continue;
    const uint16_t* bc = bh + nt * 8 + gq;
    mma_bf16(acc[n], a, pack_bf16(bc[(2 * tq) * kFPitch], bc[(2 * tq + 1) * kFPitch]),
             pack_bf16(bc[(2 * tq + 8) * kFPitch], bc[(2 * tq + 9) * kFPitch]));
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kImmaThreads, 2)
implicit_conv_kernel(const T* __restrict__ xp, const T* __restrict__ w,
                     const int* __restrict__ idx, const int* __restrict__ cnt, Epilogue ep,
                     T* __restrict__ out, int* __restrict__ skips, ConvGeom g) {
  constexpr int KS = k_step<T>();
  constexpr int WN = kImmaWarps / MT;  // warps along N per m16 tile
  constexpr int NTW = 16 / WN;         // n8 tiles per warp: nt0, nt0 + WN, ...
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned s_n8[3];                // per unit: n8 tiles with a nonzero weight
  __shared__ float s_rows[3][kMaxBn];         // this column's scale, bias, out_scale
  __shared__ __align__(16) unsigned char s_z_raw[kMaxBn * sizeof(T)];
  T* s_z = reinterpret_cast<T*>(s_z_raw);     // epilogue of a zero accumulator
  const MmaSmem L = mma_smem<T>(g, g.full);
  const UnitShape us = mma_units<T>(g, g.full);
  const int S = L.stages;
  const size_t stage_elems = L.stage / sizeof(T);
  T* ring = reinterpret_cast<T*>(smem_raw);
  int* woff = reinterpret_cast<int*>(smem_raw + L.woff);
  int* live_k = reinterpret_cast<int*>(smem_raw + L.live);
  T* win = reinterpret_cast<T*>(smem_raw + L.win);

  const int n_cols = g.n_total / g.bn;
  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // mma groupID
  const int tq = lane & 3;   // mma thread in group

  const int b = i / g.bpi;
  const int p = i % g.bpi;
  const int r0 = (p / g.spi) * g.block_oh * g.stride;
  const int q0 = (p % g.spi) * g.block_ow * g.stride;
  const int n_pix = g.block_oh * g.block_ow;
  const int kxky = g.kx * g.ky;
  const int wc = g.wpitch / static_cast<int>(sizeof(T));  // window elements per pixel
  const int bkk = (g.bk + KS - 1) / KS * KS;
  const int live = cnt[j];
  const int* idx_j = idx + static_cast<size_t>(j) * g.max_nnz;
  const int n_units = us.upt > 1 ? live * us.upt : (live + us.tpu - 1) / us.tpu;

  // requested first, in flight together: the window (all channels) and the
  // first unit of weights (one cp.async group), then units 1 .. S-2 (one
  // group each, empty past the last unit); an empty column stages nothing
  if (n_units > 0 && g.full)
    load_window<sizeof(T)>(reinterpret_cast<int8_t*>(win), reinterpret_cast<const int8_t*>(xp),
                           g, b, r0, q0, 0, g.Cp, g.wpitch, tid);
  for (int v = 0; v < S - 1; ++v) {
    if (v < n_units)
      load_wunit<T>(ring + v * stage_elems, w, g, j, idx_j, unit_at(v, us, bkk, live), tid);
    cp_async_commit();
  }
  for (int c = tid; c < g.bn; c += kImmaThreads) {
    const int n = j * g.bn + c;
    s_rows[0][c] = ep.scale != nullptr ? ep.scale[n] : 0.0f;
    s_rows[1][c] = ep.bias != nullptr ? ep.bias[n] : 0.0f;
    s_rows[2][c] = ep.out_scale != nullptr ? ep.out_scale[n] : 0.0f;
  }
  // K index -> window offset of its (channel, tap), -1 on patch padding;
  // which K steps hold any real row
  for (int k0 = 0; k0 < bkk; k0 += kImmaThreads) {
    const int k = k0 + tid;
    int wo = -1;
    if (k < bkk) {
      const int ch = k / g.slot;
      const int tap = k - ch * g.slot;
      if (k < g.bk && tap < kxky && ch < g.cpk)
        wo = ((tap / g.ky) * g.cols + (tap % g.ky)) * wc + ch;
      woff[k] = wo;
    }
    const unsigned m = __ballot_sync(0xffffffffu, wo >= 0);
    if (k < bkk && lane % KS == 0) live_k[k / KS] = ((m >> lane) & ((1u << KS) - 1u)) != 0;
  }
  if (tid < 3) s_n8[tid] = 0;
  if (n_units > 0) {
    if (S == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
  }
  __syncthreads();
  if (n_units > 0) {
    const Unit x0 = unit_at(0, us, bkk, live);
    scan_wunit<T>(ring, g, x0.ns * x0.rt, &s_n8[0], tid);
  }
  const Epilogue eps{ep.scale != nullptr ? s_rows[0] : nullptr,
                     ep.bias != nullptr ? s_rows[1] : nullptr,
                     ep.out_scale != nullptr ? s_rows[2] : nullptr, ep.relu};
  for (int c = tid; c < g.bn; c += kImmaThreads) s_z[c] = from_f32<T>(flush_epilogue<float>(0.0f, eps, c));
  __syncthreads();

  // output rows of this thread's two fragment rows, and their window offsets
  const int mt = warp / WN;
  const int nt0 = warp % WN;
  bool valid[2];
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + gq + 8 * h;
    valid[h] = m < n_pix;
    const int oh = m / g.block_ow;
    const int ow = m % g.block_ow;
    off[h] = valid[h] ? ((oh * g.stride) * g.cols + ow * g.stride) * wc : 0;
  }

  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;

  // unit u sits in ring stage u % S. At the top of iteration u it has
  // landed and been scanned, every warp is done with unit u-1, and units
  // u+1 .. u+S-2 are in flight.
  unsigned any_n8 = 0;  // n8 tiles whose weights hold a nonzero value
  for (int u = 0; u < n_units; ++u) {
    const Unit x = unit_at(u, us, bkk, live);
    const int v = u + S - 1;  // into the stage unit u-1 has left
    if (v < n_units)
      load_wunit<T>(ring + (v % S) * stage_elems, w, g, j, idx_j, unit_at(v, us, bkk, live), tid);
    cp_async_commit();
    if (!g.full && x.lo == 0) {
      // slow path (one K-tile per unit): this step's (rows, cols, cpk) window
      load_window<sizeof(T)>(reinterpret_cast<int8_t*>(win), reinterpret_cast<const int8_t*>(xp),
                             g, b, r0, q0, idx_j[x.s0] * g.cpk, g.cpk, g.wpitch, tid);
      cp_async_wait_all();
      __syncthreads();
    }
    // products only on the n8 tiles whose weights in the unit hold a
    // nonzero value; a unit's mask is cleared two units before it is
    // written again
    const unsigned n8 = s_n8[u % 3];
    if (tid == 0) s_n8[(u + 2) % 3] = 0;
    any_n8 |= n8;
    const int n_hi = 32 - __clz(n8);
    if (nt0 < n_hi) {
      const T* buf = ring + (u % S) * stage_elems;
      for (int q = 0; q < x.ns; ++q) {
        const T* wn = win + (g.full ? idx_j[x.s0 + q] * g.cpk : 0);
        const T* bq = buf + static_cast<size_t>(q) * x.rt * kFPitch;
        if constexpr (sizeof(T) == 4) {
          // two live K steps at a time where there are two
          for (int k = x.lo; k < x.lo + x.rt;) {
            const float* bk = bq + (k - x.lo) * kFPitch;
            if (k + KS < x.lo + x.rt && live_k[k / KS] && live_k[k / KS + 1]) {
              mma_steps_tf32<NTW, WN, 2>(acc, bk, wn, woff + k, valid, off, n_hi, nt0, gq, tq);
              k += 2 * KS;
            } else {
              if (live_k[k / KS])
                mma_steps_tf32<NTW, WN, 1>(acc, bk, wn, woff + k, valid, off, n_hi, nt0, gq, tq);
              k += KS;
            }
          }
        } else {
          for (int k = x.lo; k < x.lo + x.rt; k += KS)
            if (live_k[k / KS])
              mma_step_bf16<NTW, WN>(acc, bq + (k - x.lo) * kFPitch, wn, woff + k, valid, off,
                                     n8, n_hi, nt0, gq, tq);
        }
      }
    }
    if (u + 1 < n_units) {
      // unit u+1 has landed (all but the newest S-2 groups)
      if (S == 3) cp_async_wait<1>();
      else cp_async_wait<0>();
      const Unit x1 = unit_at(u + 1, us, bkk, live);
      scan_wunit<T>(ring + ((u + 1) % S) * stage_elems, g, x1.ns * x1.rt, &s_n8[(u + 1) % 3],
                    tid);
    }
    __syncthreads();
  }
  if (skips != nullptr && tid == 0) skips[i * n_cols + j] = 0;  // no activation skip here

  // flush. The n8 tiles whose weights are zero in every unit hold the
  // zero-accumulator row in every row: where the output rows allow 16-byte
  // stores (4 f32 or 8 bf16 lanes), the block writes them from s_z; every
  // other tile goes through the fragments.
  constexpr int CL = 16 / sizeof(T);
  const int n8_count = (g.bn + 7) / 8;
  const unsigned dead = ~any_n8 & ((1u << n8_count) - 1u);
  const unsigned skip = (g.bn % CL == 0 && g.n_total % CL == 0) ? dead : 0u;
  if (skip != 0) {
    const int per = g.bn / CL;  // 16-byte chunks per row
    for (int e = tid; e < g.bm * per; e += kImmaThreads) {
      const int r = e / per;
      const int ch = e - r * per;
      if (!((skip >> (ch * CL / 8)) & 1u)) continue;
      const size_t o = (static_cast<size_t>(i) * g.bm + r) * g.n_total +
                       static_cast<size_t>(j) * g.bn + CL * ch;
      *reinterpret_cast<int4*>(out + o) = *reinterpret_cast<const int4*>(s_z + CL * ch);
    }
  }
  const size_t row0 = (static_cast<size_t>(i) * g.bm + mt * 16 + gq) * g.n_total + j * g.bn;
  const int rows_left = g.bm - (mt * 16 + gq);  // rows gq (+8) exist while > 0 (> 8)
  flush_frags<sizeof(T) == 4 ? kOutF32 : kOutBF16, NTW, WN>(
      acc, eps, out, row0, g.n_total, rows_left, nt0 * 8 + 2 * tq, g.bn, skip >> nt0);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
static cudaError_t allow_shared(Kernel kernel, size_t smem, size_t static_smem) {
  // above 48 KB with the static shared memory a launch is refused unless
  // the carve-out was asked for
  if (smem + static_smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The per-block body: one block per (M-block, N-tile).
template <int MT, bool kCompact>
static cudaError_t launch_imma_per_block(const void* xp, const void* w, const int* idx,
                                         const int* cnt, const Epilogue& ep, void* out,
                                         int out_int8, int* skips, const int* ktab,
                                         const int* krows, int n_blocks, const ConvGeom& g,
                                         cudaStream_t stream) {
  auto kernel = implicit_conv_kernel_imma<MT, false, kCompact>;
  const size_t smem = imma_smem(g, g.full).total;
  cudaError_t err = allow_shared(kernel, smem, kImmaStaticBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, g.n_total / g.bn);
  kernel<<<grid, dim3(kImmaThreads), smem, stream>>>(static_cast<const int8_t*>(xp),
                                                 static_cast<const int8_t*>(w), idx, cnt, ep, out,
                                                 out_int8, skips, ktab, krows, g);
  return cudaGetLastError();
}

template <int MT>
static cudaError_t launch_imma_k(const void* xp, const void* w, const int* idx, const int* cnt,
                                 const Epilogue& ep, void* out, int out_int8, int* skips,
                                 const int* ktab, const int* krows, int n_blocks, int n_sm,
                                 const ConvGeom& g, cudaStream_t stream) {
  if (g.resident) {
    // compacted K operands (launch_imma checks): as many blocks as the card
    // holds at once, each walking M-blocks
    auto kernel = implicit_conv_kernel_imma<MT, true, true>;
    const size_t smem = resident_smem(g).total;
    cudaError_t err = allow_shared(kernel, smem, kImmaStaticBytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kImmaThreads, smem);
    if (err != cudaSuccess) return err;
    const int walkers = n_sm * (per_sm > 0 ? per_sm : 1);
    const dim3 grid(n_blocks < walkers ? n_blocks : walkers, g.n_total / g.bn);
    kernel<<<grid, dim3(kImmaThreads), smem, stream>>>(static_cast<const int8_t*>(xp),
                                                   static_cast<const int8_t*>(w), idx, cnt, ep,
                                                   out, out_int8, skips, ktab, krows, g);
    return cudaGetLastError();
  }
  if (g.compact)
    return launch_imma_per_block<MT, true>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab,
                                           krows, n_blocks, g, stream);
  return launch_imma_per_block<MT, false>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows,
                                          n_blocks, g, stream);
}

static int largest_copy(uintptr_t ptr, int Cp, int wc) {
  const int sizes[3] = {16, 8, 4};
  for (int v : sizes)
    if (ptr % v == 0 && Cp % v == 0 && wc % v == 0) return v;
  return 1;
}

static cudaError_t launch_imma(const void* xp, const void* w, const int* idx, const int* cnt,
                               const Epilogue& ep, void* out, int out_int8, int* skips,
                               const int* ktab, const int* krows, int n_blocks, int resident,
                               ConvGeom g, cudaStream_t stream) {
  // the resident window's pixels are padded to an odd number of 16-byte
  // groups (with 32 or 64 channels packed the byte loads of an A fragment
  // meet in two banks)
  g.wpitch = window_pitch(g.Cp, 1);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the host picks the resident body (`takes_resident_path`); it takes
  // compacted K operands whose units, window ring and staging a block holds
  if (resident && (!g.compact || resident_smem(g).total + kImmaStaticBytes >
                                     static_cast<size_t>(kMaxSharedBytes)))
    return cudaErrorInvalidValue;
  g.resident = resident != 0;
  // all channels of the window at once where they fit, else one K-tile's
  // (the kernel's static shared memory holds the epilogue rows); the
  // resident body always holds all of them, and compacted K operands run
  // only where the per-block body does (`takes_compact_path` on the host)
  const size_t budget = kMaxSharedBytes - kImmaStaticBytes;
  g.full = g.resident || imma_smem(g, 1).total <= budget ? 1 : 0;
  if (!g.resident && imma_smem(g, g.full).total > budget) return cudaErrorInvalidValue;
  if (g.compact && imma_smem(g, 1).total > budget) return cudaErrorInvalidValue;
  g.vec = largest_copy(reinterpret_cast<uintptr_t>(xp), g.Cp, g.full ? g.Cp : g.cpk);
  g.wvec = (reinterpret_cast<uintptr_t>(w) % 4 == 0 && g.n_total % 4 == 0 && g.bn % 4 == 0);
  g.stage_out = out_int8 && g.bn % 16 == 0 && g.n_total % 16 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0;
  switch (imma_mt(g.bm)) {
    case 1:
      return launch_imma_k<1>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows, n_blocks,
                              n_sm, g, stream);
    case 2:
      return launch_imma_k<2>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows, n_blocks,
                              n_sm, g, stream);
    case 4:
      return launch_imma_k<4>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows, n_blocks,
                              n_sm, g, stream);
    default:
      return launch_imma_k<8>(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows, n_blocks,
                              n_sm, g, stream);
  }
}

template <typename T, int MT>
static cudaError_t launch_mma_mt(const void* xp, const void* w, const int* idx, const int* cnt,
                                 const Epilogue& ep, void* out, int* skips, int n_blocks,
                                 const ConvGeom& g, cudaStream_t stream) {
  auto kernel = implicit_conv_kernel<T, MT>;
  const size_t smem = mma_smem<T>(g, g.full).total;
  cudaError_t err = allow_shared(kernel, smem, kMmaStaticBytes<T>);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, g.n_total / g.bn);
  kernel<<<grid, dim3(kImmaThreads), smem, stream>>>(static_cast<const T*>(xp),
                                                     static_cast<const T*>(w), idx, cnt, ep,
                                                     static_cast<T*>(out), skips, g);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_mma(const void* xp, const void* w, const int* idx, const int* cnt,
                              const Epilogue& ep, void* out, int* skips, int n_blocks, ConvGeom g,
                              cudaStream_t stream) {
  // all channels of the window at once where they fit, else one K-tile's;
  // padded pixels where they fit, else packed ones
  const size_t budget = kMaxSharedBytes - kMmaStaticBytes<T>;
  constexpr int es = sizeof(T);
  bool fits = false;
  for (int mode = 0; mode < 4 && !fits; ++mode) {
    g.full = mode < 2;
    g.wpitch = window_pitch((g.full ? g.Cp : g.cpk) * es, mode % 2 == 0);
    fits = mma_smem<T>(g, g.full).total <= budget;
  }
  if (!fits) return cudaErrorInvalidValue;
  g.vec = largest_copy(reinterpret_cast<uintptr_t>(xp), g.Cp * es, (g.full ? g.Cp : g.cpk) * es);
  g.wvec = (reinterpret_cast<uintptr_t>(w) % 16 == 0 && (g.n_total * es) % 16 == 0 &&
            (g.bn * es) % 16 == 0);
  if (g.bm <= 16) return launch_mma_mt<T, 1>(xp, w, idx, cnt, ep, out, skips, n_blocks, g, stream);
  if (g.bm <= 32) return launch_mma_mt<T, 2>(xp, w, idx, cnt, ep, out, skips, n_blocks, g, stream);
  if (g.bm <= 64) return launch_mma_mt<T, 4>(xp, w, idx, cnt, ep, out, skips, n_blocks, g, stream);
  return launch_mma_mt<T, 8>(xp, w, idx, cnt, ep, out, skips, n_blocks, g, stream);
}

}  // namespace hapm

// xp (B, Hp, Wp, Cp) padded NHWC, w (nKb*bk, n_total) packed weight, both of
// `dtype`; idx (n_total/bn, max_nnz), cnt (n_total/bn) int32; scale / bias /
// out_scale f32 rows of length n_total or null; out (B*bpi*bm, n_total) in
// the operand's float type (f32 for int8 codes) or int8 codes when out_scale
// is given; skips (B*bpi, n_total/bn) int32 or null. Compacted K operands
// (int8 codes, no dsb): ktab (n_total/bn, kpad) int32 table entries and
// krows (n_total/bn) int32 row counts, multiples of 32, with w the compacted
// weight (kpad, n_total), kpad a multiple of 128; else ktab and krows null.
// resident (compacted operands only): the resident body where nonzero, as
// `takes_resident_path` picks it on the host. Returns the launch's
// cudaError_t (0 = launched; a resident launch on padded operands or past a
// block's shared memory, or compacted operands whose window does not fit,
// is refused).
extern "C" int hapm_implicit_block_sparse_conv(
    const void* xp, const void* w, const int* idx, const int* cnt, const float* scale,
    const float* bias, const float* out_scale, void* out, int* skips, const int* ktab,
    const int* krows, int B, int Hp, int Wp, int Cp, int n_total, int max_nnz, int kx, int ky,
    int stride, int block_oh, int block_ow, int spi, int bpi, int bm, int bk, int bn, int cpk,
    int slot, int dtype, int relu, int dsb, int resident, int kpad, void* stream) {
  using namespace hapm;
  ConvGeom g;
  g.Hp = Hp; g.Wp = Wp; g.Cp = Cp;
  g.n_total = n_total; g.max_nnz = max_nnz;
  g.kx = kx; g.ky = ky; g.stride = stride;
  g.block_oh = block_oh; g.block_ow = block_ow; g.spi = spi; g.bpi = bpi;
  g.bm = bm; g.bk = bk; g.bn = bn; g.cpk = cpk; g.slot = slot;
  g.rows = (block_oh - 1) * stride + kx;
  g.cols = (block_ow - 1) * stride + ky;
  g.dsb = dsb;
  g.full = g.vec = g.wvec = g.wpitch = g.resident = g.stage_out = 0;
  g.compact = ktab != nullptr;
  g.kpad = kpad;
  if (bm < 1 || bm > kMaxBn || bn < 1 || bn > kMaxBn || n_total % bn || Cp % cpk || slot < 1 ||
      block_oh * block_ow > bm || (dsb && dtype != kI8) ||
      (g.compact && (dtype != kI8 || dsb || krows == nullptr || kpad < kUnitK || kpad % kUnitK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{scale, bias, out_scale, relu};
  const int out_int8 = (dtype == kI8 && out_scale != nullptr) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = B * bpi;
  g.n_mb = n_blocks;
  if (resident && dtype != kI8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch_mma<float>(xp, w, idx, cnt, ep, out, skips, n_blocks, g, st);
      break;
    case kBF16:
      err = launch_mma<__nv_bfloat16>(xp, w, idx, cnt, ep, out, skips, n_blocks, g, st);
      break;
    case kI8:
      err = launch_imma(xp, w, idx, cnt, ep, out, out_int8, skips, ktab, krows, n_blocks, resident,
                        g, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
