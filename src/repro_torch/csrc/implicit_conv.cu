// Implicit-im2col block-sparse convolution for Hopper (sm_90a), forward.
//
// Replaces the Pallas TPU kernel `implicit_block_sparse_conv`
// (src/repro/kernels/implicit_conv.py, body `_kernel`): the same GEMM and
// epilogue as the block-sparse matmul, but the x operand is the padded NHWC
// activation left in device memory. For M-block (b, p) and live K-tile t
// the kernel reads the window
//     xp[b, r0 : r0+rows, q0 : q0+cols, t*cpk : (t+1)*cpk]
// and multiplies the patch rows
//     pt[oh*block_ow + ow, c*slot + dy*ky + dx] = win[oh*stride+dy, ow*stride+dx, c]
// (zero elsewhere) with the (bk, bn) weight tile. The patch matrix never
// exists in device memory.
//
// What bounds it on this card: bytes. A live step moves one activation
// window and one weight tile and does at most bm*bk*bn multiply-adds, most
// of them on lane padding, so the least time the card could take is set by
// its memory rate, not its arithmetic rate.
//
// What the design does about it (right and simple first; tensor cores, TMA
// and pipelining are not used yet):
//   * one thread block per (M-block i, N-tile j); the TPU grid's sequential
//     third axis is a loop over the live tiles of column j inside the block,
//     accumulator in registers. The TPU version's double-buffered window
//     DMA becomes a plain staged load; many blocks per SM hide its latency.
//   * the (rows, cols, cpk) window is staged once per live tile in dynamic
//     shared memory (converted to the accumulator type) and every tap is
//     read from the staged copy; the weight tile is staged in 32-row slices
//     so the block's shared memory is window + 16 KB. Above 48 KB the
//     launcher asks for the larger carve-out; a window that cannot fit the
//     card's 227 KB is refused by the Python wrapper before launch.
//   * weight rows that only meet patch padding (tap >= kx*ky within a
//     channel slot, channels past cpk) are skipped: they multiply zeros.
//   * activation_dsb: while staging, every thread notes whether it saw a
//     non-zero code; one block-wide __syncthreads_or over the WHOLE staged
//     window (not only the tapped pixels — with stride 2 they differ)
//     decides, uniformly for the block, to skip the weight staging and the
//     products of that tile. The accumulator is untouched on a skip, so the
//     result is bit-identical. count_skips: thread 0 writes the block's skip
//     count to skips[i, j].
//   * a column with cnt[j] == 0 still flushes the epilogue on zeros, and the
//     rows of the M-block past block_oh*block_ow flush the epilogue of a
//     zero accumulator, as in the TPU kernel.
//   * sizes are runtime arguments; the only template parameters are the
//     operand type and the rows per thread (4 x 3 instances in all).
#include "epilogue.cuh"

namespace hapm {

constexpr int kSliceRows = 32;  // weight-tile rows staged at a time
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block may use on sm_90

struct ConvGeom {
  int Hp, Wp, Cp;         // padded input (B, Hp, Wp, Cp)
  int n_total, max_nnz;   // packed output columns, idx row length
  int kx, ky, stride;
  int block_oh, block_ow, spi, bpi;
  int bm, bk, bn, cpk, slot;
  int rows, cols;         // window shape
  int dsb;                // skip all-zero windows (int8 codes only)
};

template <typename T, typename Acc, int RM>
__global__ void __launch_bounds__(kThreads)
implicit_conv_kernel(const T* __restrict__ xp, const T* __restrict__ w,
                     const int* __restrict__ idx, const int* __restrict__ cnt, Epilogue ep,
                     void* __restrict__ out, int out_int8, int* __restrict__ skips, ConvGeom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int win_elems = g.rows * g.cols * g.cpk;
  Acc* win = reinterpret_cast<Acc*>(smem_raw);
  Acc(*ws)[kMaxBn] = reinterpret_cast<Acc(*)[kMaxBn]>(win + ((win_elems + 3) / 4) * 4);

  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;

  const int b = i / g.bpi;
  const int p = i % g.bpi;
  const int r0 = (p / g.spi) * g.block_oh * g.stride;
  const int q0 = (p % g.spi) * g.block_ow * g.stride;
  const int n_pix = g.block_oh * g.block_ow;
  const int kxky = g.kx * g.ky;

  // window offset of each of this thread's output pixels (tap (0, 0), channel 0)
  int off[RM];
  bool valid[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int m = ty + kTy * a;
    valid[a] = m < n_pix;
    const int oh = m / g.block_ow;
    const int ow = m % g.block_ow;
    off[a] = valid[a] ? ((oh * g.stride) * g.cols + ow * g.stride) * g.cpk : 0;
  }

  Acc acc[RM][kColsPerThread];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[a][c] = 0;

  int skipped = 0;
  const int live = cnt[j];
  for (int s = 0; s < live; ++s) {
    const int t = idx[j * g.max_nnz + s];
    __syncthreads();  // the previous tile's products are done with win / ws
    int nonzero = 0;
    for (int e = tid; e < win_elems; e += kThreads) {
      const int c = e % g.cpk;
      const int q = (e / g.cpk) % g.cols;
      const int r = e / (g.cpk * g.cols);
      const size_t src =
          ((static_cast<size_t>(b) * g.Hp + r0 + r) * g.Wp + q0 + q) * g.Cp + t * g.cpk + c;
      const Acc v = to_acc<Acc>(xp[src]);
      win[e] = v;
      nonzero |= (v != 0);
    }
    if (g.dsb) {
      if (!__syncthreads_or(nonzero)) {  // uniform for the block
        ++skipped;
        continue;
      }
    } else {
      __syncthreads();
    }
    for (int k0 = 0; k0 < g.bk; k0 += kSliceRows) {
      const int kc = min(kSliceRows, g.bk - k0);
      if (k0 > 0) __syncthreads();  // the previous slice's products are done
      for (int e = tid; e < kSliceRows * kMaxBn; e += kThreads) {
        const int k = e / kMaxBn;
        const int c = e % kMaxBn;
        Acc v = 0;
        if (k < kc && c < g.bn)
          v = to_acc<Acc>(w[(static_cast<size_t>(t) * g.bk + k0 + k) * g.n_total + j * g.bn + c]);
        ws[k][c] = v;
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const int ch = (k0 + k) / g.slot;
        const int tap = (k0 + k) % g.slot;
        if (tap >= kxky || ch >= g.cpk) continue;  // patch padding: zeros
        const int woff = ((tap / g.ky) * g.cols + (tap % g.ky)) * g.cpk + ch;
        Acc av[RM], bv[kColsPerThread];
#pragma unroll
        for (int a = 0; a < RM; ++a) av[a] = valid[a] ? win[off[a] + woff] : static_cast<Acc>(0);
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) bv[c] = ws[k][tx + kTx * c];
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) acc[a][c] = mac(av[a], bv[c], acc[a][c]);
      }
    }
  }
  if (skips != nullptr && tid == 0) skips[i * gridDim.y + j] = skipped;
  flush_tile<T, Acc, RM>(acc, ep, out, out_int8, i, j, g.bm, g.bn, g.n_total, ty, tx);
}

static size_t shared_bytes(const ConvGeom& g) {
  const size_t win_elems = static_cast<size_t>(g.rows) * g.cols * g.cpk;
  return (((win_elems + 3) / 4) * 4 + static_cast<size_t>(kSliceRows) * kMaxBn) * 4;
}

template <typename T, typename Acc, int RM>
static cudaError_t launch_rm(const void* xp, const void* w, const int* idx, const int* cnt,
                             const Epilogue& ep, void* out, int out_int8, int* skips, int n_blocks,
                             const ConvGeom& g, cudaStream_t stream) {
  auto kernel = implicit_conv_kernel<T, Acc, RM>;
  const size_t smem = shared_bytes(g);
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the carve-out was asked for
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_blocks, g.n_total / g.bn);
  kernel<<<grid, dim3(kThreads), smem, stream>>>(static_cast<const T*>(xp),
                                                 static_cast<const T*>(w), idx, cnt, ep, out,
                                                 out_int8, skips, g);
  return cudaGetLastError();
}

template <typename T, typename Acc>
static cudaError_t launch(const void* xp, const void* w, const int* idx, const int* cnt,
                          const Epilogue& ep, void* out, int out_int8, int* skips, int n_blocks,
                          const ConvGeom& g, cudaStream_t stream) {
  if (g.bm <= 16)
    return launch_rm<T, Acc, 1>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, stream);
  if (g.bm <= 32)
    return launch_rm<T, Acc, 2>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, stream);
  if (g.bm <= 64)
    return launch_rm<T, Acc, 4>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, stream);
  return launch_rm<T, Acc, 8>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, stream);
}

}  // namespace hapm

// xp (B, Hp, Wp, Cp) padded NHWC, w (nKb*bk, n_total) packed weight, both of
// `dtype`; idx (n_total/bn, max_nnz), cnt (n_total/bn) int32; scale / bias /
// out_scale f32 rows of length n_total or null; out (B*bpi*bm, n_total) in
// the operand's float type (f32 for int8 codes) or int8 codes when out_scale
// is given; skips (B*bpi, n_total/bn) int32 or null. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int hapm_implicit_block_sparse_conv(
    const void* xp, const void* w, const int* idx, const int* cnt, const float* scale,
    const float* bias, const float* out_scale, void* out, int* skips, int B, int Hp, int Wp, int Cp,
    int n_total, int max_nnz, int kx, int ky, int stride, int block_oh, int block_ow, int spi,
    int bpi, int bm, int bk, int bn, int cpk, int slot, int dtype, int relu, int dsb,
    void* stream) {
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
  if (bm < 1 || bm > kTy * 8 || bn < 1 || bn > kMaxBn || n_total % bn || Cp % cpk || slot < 1 ||
      block_oh * block_ow > bm || (dsb && dtype != kI8) ||
      shared_bytes(g) > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{scale, bias, out_scale, relu};
  const int out_int8 = (dtype == kI8 && out_scale != nullptr) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = B * bpi;
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float, float>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16, float>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, st);
      break;
    case kI8:
      err = launch<int8_t, int>(xp, w, idx, cnt, ep, out, out_int8, skips, n_blocks, g, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
