"""Implicit-im2col block-sparse conv — the DSB kernel gathers its own patches.

The materializing path (:mod:`repro_torch.kernels.conv_lowering` +
``sparse.conv_plan``) lowers a conv to ``patches @ W`` by writing a
``(B·Ho·Wo, kx·ky·cin)`` patch matrix to device memory — a kx·ky× blowup
of the activation — and then repacking it onto the padded tile grid, per
call, per layer. The paper's accelerator never does that: kernel windows
stream straight out of the input feature map while the DSB skips pruned
groups. This kernel executes the same contract:

- Work is split into ``(B·bpi, nNb)`` blocks — M-blocks × output tile
  columns — each looping over the live K-tiles of its column, exactly like
  :mod:`block_sparse_matmul`.
- The x operand is the **padded NHWC activation itself**. Per live K-tile
  the kernel reads only the *window* its M-block needs — ``(rows, cols,
  cpk)`` where ``rows/cols`` cover ``block_oh × block_ow`` output pixels at
  the conv's stride — and forms the patch rows from it in fast memory.
  Pruned groups cost nothing: dead tiles are never in the table.
- M-blocking is **adaptive**: an M-block is ``block_oh`` whole output
  rows (``bm = ceil8(block_oh·Wo) ≤ cap``), and when even one output row
  exceeds the cap the row is split into ``spi`` **column segments** of
  ``block_ow`` pixels. :func:`choose_m_block` returns the :class:`MBlock`
  geometry; blocks never straddle images.
- The fused dequant/bias/ReLU/requantize flush epilogue carries over
  unchanged.

**Activation-side DSB** (``activation_dsb=True``, int8 codes only):
post-ReLU zeros are *exact* integer codes, so the kernel reduces each
staged window to an any-nonzero flag and skips the tile's products when the
whole window is zero. The accumulator is untouched on a skip, so results
stay bit-exact. ``count_skips=True`` adds a second output — a
``(B·bpi, nNb)`` int32 skip counter.

Two implementations of the one function live here:

- :func:`implicit_block_sparse_conv` — the wrapper. For a CUDA tensor it
  launches the hand-written kernel ``csrc/implicit_conv.cu`` (or raises);
  for a CPU tensor, and only then, it runs the plain version. Both of the
  kernel's instances multiply on the tensor cores (``mma.sync``) from a
  window staged once per block with all its channels: int8 codes with exact
  int32 sums, deciding every step's activation skip from that copy before
  the product loop; f32 operands as 3×TF32 (each operand split into two
  TF32 halves, three products summed in f32: within 1e-4, where one TF32
  product is not) and bf16 operands with exact products, both in f32. The
  int8 instance has a second, resident body for large launches on compacted
  K operands (every conv of the served CIFAR net at batch 2048): as many
  blocks as the card holds, each converting its column's weights once and
  walking M-blocks. The launch's geometry picks it
  (:func:`takes_resident_path`; the rule lives here alone, and the C
  launcher only refuses a resident launch on padded operands or past a
  block's shared memory); the recorder counts it (``RESIDENT``). Every
  launch on padded operands takes the per-block body.

**Compacted K** (int8 codes, without ``activation_dsb``): a packed K-tile
gives each input channel a slot of ``ceil8(kx·ky)`` rows, so a 1×1 tile
holds one tap in eight rows and a 3×3 tile nine in sixteen. The bind
(:func:`compact_k`, once a layer) lists, for each output column, only the
rows of its live tiles that hold a channel's tap — tiles in the table's
order, channels, taps row-major — padded to 32, and gathers those rows of
the packed weight into a dense weight of 128-row units beside a table of
each row's (channel, dy, dx). Both bodies of the int8 instance then walk a
column's units and gather A fragments through that table; the plan, the
tile mask and the dispatch table stay as they are, and int32 sums are exact
in any order, so the codes are those of the padded operands. It takes the
launches whose window of all channels one block holds
(:func:`takes_compact_path`); the recorder counts them (``COMPACT``). A
bind with ``activation_dsb`` keeps the padded tiles: its skip is decided
per K-tile window.
- :func:`implicit_block_sparse_conv_plain` — the same function in plain
  PyTorch on the same packed operands and tables; the CPU path and the
  yardstick the kernel is held to on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from . import _build
from .block_sparse_matmul import (DTYPE_CODES, KERNEL_MAX_BM, KERNEL_MAX_BN,
                                  epilogue_rows, flush_epilogue,
                                  live_columns_by_tile, quantized_contract)
from .conv_lowering import pad_nhwc, same_pads
from .ref import int_matmul_exact

# Accounting constant kept from the JAX package under its own name: the
# largest activation working set (bytes, two window buffers) for which a
# layer is *reported* and dispatched as implicit. It decides ``report()``'s
# implicit flags and the per-call fallback, so the port's accounting equals
# the JAX package's. It is not a property of the GPU; the card's own limit
# is :func:`window_fits_card`.
SLAB_VMEM_BUDGET = 2 * 1024 * 1024

# What a thread block of the CUDA kernel may hold in shared memory (sm_90),
# and what its f32/bf16 instance needs beside a per-step window: two weight
# units of one K step (8.5 KB), the K-index table and the epilogue rows,
# under 16 KB for any tile up to 1024 rows deep.
CARD_SHARED_BYTES = 232448
_BESIDE_WINDOW_BYTES = 16 * 1024

LAUNCHES = "kernel.implicit_block_sparse_conv.launches"
RESIDENT = "kernel.implicit_block_sparse_conv.resident"
COMPACT = "kernel.implicit_block_sparse_conv.compact"
# K rows the launches multiply (M-blocks x, over the live columns, the live
# K-tiles x the tile's rows, or on compacted operands the column's tap rows
# rounded up to 32), and those of them that hold a real tap (an input
# channel's kx*ky taps, not slot or channel padding); the bound conv adds
# both per call, the plain version's on the CPU included
# (``sparse.conv_plan.make_sparse_conv``)
K_ROWS = "kernel.implicit_block_sparse_conv.k_rows"
TAP_ROWS = "kernel.implicit_block_sparse_conv.tap_rows"

# The int8 instance's shared memory, mirrored from csrc/implicit_conv.cu
# (`imma_smem`, `resident_smem`): the static shared memory of the int8
# kernel, a packed 128-row weight unit, the windows in flight, and what the
# per-block body holds beside its window on compacted operands (two packed
# units, a raw ring of three units with their 128 table entries, and two
# units' window offsets). What one SM holds and a block's reserve beside it
# are the resident rule's (:func:`takes_resident_path`), which only this
# module applies.
SM_SHARED_BYTES = 233472
_BLOCK_RESERVE_BYTES = 1024
_IMMA_STATIC_BYTES = 4 * KERNEL_MAX_BN * 4 + KERNEL_MAX_BN + 16
_UNIT_ROWS = 128
_UNIT_BYTES = 32 * (KERNEL_MAX_BN + 8) * 4
_WINDOW_RING = 2
_COMPACT_BESIDE_WINDOW_BYTES = (2 * _UNIT_BYTES + 3 * _UNIT_ROWS * (KERNEL_MAX_BN + 4)
                                + 2 * _UNIT_ROWS * 4)


def window_pitch(cp: int) -> int:
    """Bytes per window pixel of ``cp`` int8 channels in the resident path's
    shared memory: padded to an odd number of 16-byte groups (with 32 or 64
    channels packed, the byte loads of an A fragment meet in two banks)."""
    return 16 * (-(-cp // 16) | 1) if cp >= 16 else cp


def resident_smem_bytes(bm: int, window_bytes: int, k_units: int) -> int:
    """Shared memory a block of the int8 instance's resident body holds:
    the ``k_units`` 128-row units of the widest column of a launch's
    compacted K operands (:class:`CompactK`) with a window offset for each
    of their rows and an n8 mask each, 16 staging rows of output codes an
    m16 tile, two windows of ``window_bytes`` (window pixels times
    :func:`window_pitch`), and the static epilogue rows."""
    mt = 1 if bm <= 16 else 2 if bm <= 32 else 4 if bm <= 64 else 8
    return (k_units * _UNIT_BYTES + _ceil_to(k_units * _UNIT_ROWS * 4, 16)
            + _ceil_to(k_units * 4, 16) + mt * 16 * (KERNEL_MAX_BN + 16)
            + _WINDOW_RING * _ceil_to(window_bytes, 16) + _IMMA_STATIC_BYTES)


def takes_resident_path(n_blocks: int, bm: int, window_bytes: int, n_sm: int,
                        k_units: int) -> bool:
    """Whether a launch of the int8 instance on compacted K operands (the
    widest column ``k_units`` 128-row units) over ``n_blocks`` M-blocks
    takes the resident body on a card of ``n_sm`` SMs: weight-stationary
    blocks, as many as the card holds at once, each converting its column's
    weight units once and walking M-blocks. It does where the units, the
    window ring and the staging fit a block's shared memory and each such
    block (at most two an SM) walks at least two M-blocks; elsewhere
    (batch-1 serving, windows or columns too large) every (M-block, column)
    gets a block of its own, as does every launch on padded operands. The
    rule's only copy: the launcher takes the choice as given."""
    need = resident_smem_bytes(bm, window_bytes, k_units)
    if need > CARD_SHARED_BYTES:
        return False
    per_sm = min(2, SM_SHARED_BYTES // (need + _BLOCK_RESERVE_BYTES))
    return n_blocks >= 2 * n_sm * per_sm


@functools.lru_cache(maxsize=None)
def takes_compact_path(rows: int, cols: int, cp: int) -> bool:
    """Whether a launch of the int8 instance may run on compacted K
    operands: where one block holds the window of all ``cp`` channels (``rows
    × cols`` pixels) beside the per-block body's weight ring. A compacted
    unit mixes K-tiles, so the slow path, which restages one K-tile's
    channels per step, cannot run it; the resident body holds all channels
    wherever it is taken, and needs more beside them. The launcher refuses a
    compacted launch that breaks this rule."""
    return (_COMPACT_BESIDE_WINDOW_BYTES + _ceil_to(rows * cols * cp, 16)
            + _IMMA_STATIC_BYTES <= CARD_SHARED_BYTES)


class CompactK(NamedTuple):
    """K2 int8's compacted K operands of one bound conv (:func:`compact_k`):
    for output column ``j`` its ``rows[j]`` rows, the tap rows of its live
    K-tiles rounded up to 32, in lanes ``j*bn .. (j+1)*bn`` of ``w``;
    contiguous, on the packed weight's device. The kernel's wrapper takes
    them as :func:`compact_k` built them; the plain version checks them."""
    w: torch.Tensor      # (kpad, n_total) int8; zero past a column's rows
    tab: torch.Tensor    # (nNb, kpad) int32: (channel << 16) | (dy << 8) | dx; -1 past
    rows: torch.Tensor   # (nNb,) int32, multiples of 32; kpad = 128 * k_units
    k_rows: int          # sum of ``rows``: the K rows an M-block multiplies

    @property
    def k_units(self) -> int:
        """128-row units of the widest column."""
        return self.w.shape[0] // _UNIT_ROWS


def column_tap_rows(idx, cnt, *, kx: int, ky: int, cin: int, cpk: int) -> np.ndarray:
    """Per output column, the K rows of its live K-tiles that hold a tap:
    ``kx·ky`` for each of a tile's channels below ``cin``."""
    idx, cnt = np.asarray(idx, np.int64), np.asarray(cnt)
    live = np.arange(idx.shape[1])[None, :] < cnt[:, None]
    return kx * ky * (np.clip(cin - idx * cpk, 0, cpk) * live).sum(axis=1)


def compact_rows(idx, cnt, *, kx: int, ky: int, cin: int, cpk: int, slot: int,
                 bk: int):
    """Per output column, the packed K rows that hold a tap of its live
    K-tiles and each row's table entry: ``(src, tab)``, two ``(nNb, n)``
    int64 arrays, ``-1`` past a column's :func:`column_tap_rows` rows;
    tiles in the table's order (``idx[j, :cnt[j]]``), then the tile's
    channels below ``cin``, then the taps row-major."""
    idx, cnt = np.asarray(idx, np.int64), np.asarray(cnt)
    n_cols, nnz = idx.shape
    tap = np.arange(kx * ky)
    c = np.arange(cpk)
    ch = idx[:, :, None] * cpk + c                       # (nNb, nnz, cpk)
    keep = (np.arange(nnz)[None, :, None] < cnt[:, None, None]) & (ch < cin)
    k = ((idx[:, :, None] * bk + c * slot)[..., None] + tap).reshape(n_cols, -1)
    e = (ch[..., None] << 16 | (tap // ky) << 8 | tap % ky).reshape(n_cols, -1)
    keep = np.repeat(keep.reshape(n_cols, -1), kx * ky, axis=1)
    pos = np.cumsum(keep, axis=1) - 1                    # the row a kept entry takes
    width = int(pos[:, -1].max(initial=-1)) + 1 if keep.shape[1] else 0
    src = np.full((n_cols, width), -1, np.int64)
    tab = np.full((n_cols, width), -1, np.int64)
    j, f = np.nonzero(keep)
    src[j, pos[j, f]], tab[j, pos[j, f]] = k[j, f], e[j, f]
    return src, tab


def compact_k(w: torch.Tensor, idx, cnt, *, kx: int, ky: int, cin: int, cpk: int,
              slot: int, block: Tuple[int, int]) -> CompactK:
    """K2 int8's compacted K operands, built once at bind from the packed
    masked int8 weight ``w`` and the host dispatch table: each column's tap
    rows (:func:`compact_rows`) gathered from a host copy of ``w`` into a
    dense weight, zero rows to a multiple of 32 and, across columns, to the
    widest column's 128-row units, then uploaded once. The rows dropped are
    the packed layout's zero padding, so the products are the padded
    tiles' sums."""
    bk, bn = block
    if cin >= 1 << 15 or kx > 255 or ky > 255:
        raise ValueError(f"compacted K tables hold channels < 32768 and taps < 256, "
                         f"got cin={cin}, kernel {kx}x{ky}")
    n_cols = w.shape[1] // bn
    if not (w.dtype == torch.int8 and w.dim() == 2 and w.shape[0] % bk == 0
            and w.shape[1] % bn == 0 and np.shape(idx)[0] == n_cols):
        raise ValueError(f"compact_k takes a packed int8 weight on the {block} grid and "
                         f"its table, got {w.dtype} {tuple(w.shape)} and "
                         f"{np.shape(idx)[0]} columns")
    src, tab = compact_rows(idx, cnt, kx=kx, ky=ky, cin=cin, cpk=cpk, slot=slot, bk=bk)
    rows = (-(-(src >= 0).sum(axis=1) // 32) * 32).astype(np.int32)
    kpad = max(_UNIT_ROWS, _ceil_to(int(rows.max(initial=0)), _UNIT_ROWS))
    pad = ((0, 0), (0, kpad - src.shape[1]))
    # row r of column j's lanes: packed row src[r, j] (-1: zeros)
    src = np.pad(src, pad, constant_values=-1).T
    wh = w.detach().cpu().numpy().reshape(w.shape[0], n_cols, bn)
    wc = wh[src.clip(min=0), np.arange(n_cols)[None, :]]      # (kpad, nNb, bn)
    wc[src < 0] = 0
    tab = np.pad(tab, pad, constant_values=-1).astype(np.int32)
    dev = w.device
    return CompactK(torch.from_numpy(wc.reshape(kpad, -1)).to(dev),
                    torch.from_numpy(tab).to(dev), torch.from_numpy(rows).to(dev),
                    int(rows.sum()))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class MBlock(NamedTuple):
    """Adaptive M-block geometry: ``block_oh × block_ow`` output pixels
    per block, ``spi`` column segments per row band, ``bpi =
    ceil(ho/block_oh)·spi`` M-blocks per image."""
    block_oh: int
    block_ow: int
    spi: int
    bm: int
    bpi: int


def choose_m_block(ho: int, wo: int, cap: int = 128) -> Optional[MBlock]:
    """Adaptive M-blocking: whole output rows per block, column segments
    when a row is too wide.

    Picks the largest ``block_oh`` whole output rows with ``bm =
    ceil8(block_oh·wo) ≤ cap``: a 4×4 output runs at ``bm=16``, an 8×8 at
    ``bm=64``. When even one output row exceeds ``cap`` the row splits into
    ``spi = ceil(wo/block_ow)`` column segments of ``block_ow =
    8·⌊cap/8⌋`` pixels. ``None`` only when the cap can't fit one 8-pixel
    segment. Blocks never straddle images.
    """
    if ho < 1 or wo < 1:
        return None
    if _ceil_to(wo, 8) <= cap:
        block_oh = max(b for b in range(1, ho + 1)
                       if _ceil_to(b * wo, 8) <= cap)
        return MBlock(block_oh, wo, 1, _ceil_to(block_oh * wo, 8),
                      -(-ho // block_oh))
    block_ow = (cap // 8) * 8
    if block_ow < 8:
        return None
    spi = -(-wo // block_ow)
    return MBlock(1, block_ow, spi, block_ow, ho * spi)


def window_shape(mb: MBlock, kx: int, ky: int, stride: int) -> Tuple[int, int]:
    """(rows, cols) of padded input one M-block's window covers — what the
    kernel stages per live step."""
    return ((mb.block_oh - 1) * stride + kx,
            (mb.block_ow - 1) * stride + ky)


def window_fits_card(rows: int, cols: int, cpk: int) -> bool:
    """Whether the CUDA kernel's block can stage this window of one K-tile's
    ``cpk`` channels: at 4 bytes an element (f32) beside 16 KB in the
    card's shared memory, which the f32/bf16 instance's per-step path needs
    at most (the int8 instance holds the window as bytes beside 82 KB of
    weight buffers, which fits wherever this does). Where the window of all
    channels fits as well, both instances stage it once per block instead.
    The second condition beside :data:`SLAB_VMEM_BUDGET`; a window that
    fails it takes the materializing path."""
    win = _ceil_to(rows * cols * cpk, 4) * 4
    return win + _BESIDE_WINDOW_BYTES <= CARD_SHARED_BYTES


def pad_input(x: torch.Tensor, kx: int, ky: int, stride: int, padding: str,
              mb: MBlock, c_packed: int) -> torch.Tensor:
    """Zero-pad an NHWC input for the implicit kernel: the conv's own
    SAME/VALID pads, extra trailing rows/columns so the *last* M-block's
    window stays in bounds (its tail output pixels are cropped after the
    kernel), and channel padding to the packed K grid. One pad — no kx·ky
    patch blowup, no transpose."""
    B, H, W, C = x.shape
    if padding == "SAME":
        (pt, pb), (pw0, pw1) = same_pads(H, kx, stride), same_pads(W, ky, stride)
    else:
        pt = pb = pw0 = pw1 = 0
    rb = mb.bpi // mb.spi
    rows_need = (rb - 1) * mb.block_oh * stride \
        + (mb.block_oh - 1) * stride + kx
    cols_need = (mb.spi - 1) * mb.block_ow * stride \
        + (mb.block_ow - 1) * stride + ky
    extra_r = max(rows_need - (H + pt + pb), 0)
    extra_c = max(cols_need - (W + pw0 + pw1), 0)
    return pad_nhwc(x, (pt, pb + extra_r), (pw0, pw1 + extra_c),
                    (0, c_packed - C))


def crop_output(out2d: torch.Tensor, mb: MBlock, batch: int, ho: int,
                wo: int) -> torch.Tensor:
    """Undo the M-block tiling: ``(B·bpi·bm, n_packed)`` kernel output →
    ``(B, ho, wo, n_packed)`` with the bm row padding and block
    overhang dropped."""
    rb = mb.bpi // mb.spi
    o = out2d.reshape(batch, rb, mb.spi, mb.bm, -1)
    o = o[:, :, :, :mb.block_oh * mb.block_ow]
    o = o.reshape(batch, rb, mb.spi, mb.block_oh, mb.block_ow, -1)
    o = o.permute(0, 1, 3, 2, 4, 5)
    o = o.reshape(batch, rb * mb.block_oh, mb.spi * mb.block_ow, -1)
    return o[:, :ho, :wo]


def _check_operands(xp, w, idx, cnt, kx, ky, stride, mb, block, cpk,
                    activation_dsb, compact=None):
    B, Hp, Wp, Cp = xp.shape
    bk, bn = block
    if not (Cp % cpk == 0 and w.shape[0] % bk == 0 and w.shape[1] % bn == 0):
        raise ValueError(
            f"packed shapes off-grid: x {tuple(xp.shape)} (cpk={cpk}), w "
            f"{tuple(w.shape)}, block={block}")
    if activation_dsb and xp.dtype != torch.int8:
        raise TypeError(
            "activation_dsb keys the skip on exact int8 zero codes — "
            "quantize the activation (quant=...) to use it")
    if compact is not None:
        # the plain version's check; the kernel's wrapper takes compact_k's
        nNb, kpad = w.shape[1] // bn, compact.w.shape[0]
        if xp.dtype != torch.int8 or compact.w.dtype != torch.int8 or activation_dsb:
            raise TypeError("compacted K operands take int8 codes without "
                            "activation_dsb (its skip is decided per K-tile)")
        if not (tuple(compact.w.shape) == (kpad, w.shape[1]) and kpad % _UNIT_ROWS == 0
                and tuple(compact.tab.shape) == (nNb, kpad)
                and tuple(compact.rows.shape) == (nNb,)):
            raise ValueError(
                f"compacted K operands off-grid: w {tuple(compact.w.shape)}, tab "
                f"{tuple(compact.tab.shape)}, rows {tuple(compact.rows.shape)} for "
                f"{nNb} columns of {bn} lanes")
    rows, cols = window_shape(mb, kx, ky, stride)
    rb = mb.bpi // mb.spi
    if not ((rb - 1) * mb.block_oh * stride + rows <= Hp
            and (mb.spi - 1) * mb.block_ow * stride + cols <= Wp):
        raise ValueError(
            f"window out of bounds: pad_input() with this MBlock first "
            f"(xp {tuple(xp.shape)}, mb {mb}, k ({kx},{ky}), stride {stride})")
    if mb.block_oh * mb.block_ow > mb.bm or w.shape[0] // bk * cpk != Cp:
        raise ValueError(
            f"M-block / K grid mismatch: mb {mb}, xp channels {Cp}, "
            f"{w.shape[0] // bk} K-tiles of {cpk} channels")
    nNb = w.shape[1] // bn
    if not (idx.dim() == 2 and idx.shape[0] == nNb
            and tuple(cnt.shape) == (nNb,)):
        raise ValueError(
            f"dispatch table off-grid: idx {tuple(idx.shape)}, cnt "
            f"{tuple(cnt.shape)} for {nNb} column tiles")
    return rows, cols, nNb


def implicit_block_sparse_conv_plain(
    xp: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, cnt: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    out_scale: Optional[torch.Tensor] = None,
    *,
    kx: int, ky: int, stride: int,
    mb: MBlock,
    block: Tuple[int, int], cpk: int, slot: int,
    relu: bool = False,
    activation_dsb: bool = False,
    count_skips: bool = False,
    compact: Optional[CompactK] = None,
):
    """The plain PyTorch version of :func:`implicit_block_sparse_conv`: per
    live K-tile it slices every M-block's window out of the padded input,
    forms the patch rows from ``kx·ky`` strided slices of the windows, and
    multiplies them with the weight tiles of the output columns that visit
    the tile — f32 (int32 for codes) accumulation in ascending tile order,
    all-zero windows masked out under ``activation_dsb``, then the shared
    epilogue. On ``compact`` operands it gathers, per output column, the
    patch rows its table lists from the windows of all channels and
    multiplies them with the column's compacted weight."""
    rows, cols, nNb = _check_operands(xp, w, idx, cnt, kx, ky, stride, mb,
                                      block, cpk, activation_dsb, compact)
    B = xp.shape[0]
    bk, bn = block
    n_total = w.shape[1]
    acc_dtype, out_dtype = quantized_contract(xp, w, scale, out_scale)
    scale, bias, out_scale = epilogue_rows(n_total, xp.device, scale=scale,
                                           bias=bias, out_scale=out_scale)
    boh, bow, bpi, bm = mb.block_oh, mb.block_ow, mb.bpi, mb.bm
    n_blocks = B * bpi
    acc = torch.zeros((n_blocks, bm, nNb, bn), dtype=acc_dtype,
                      device=xp.device)
    skips = torch.zeros((n_blocks, nNb), dtype=torch.int32, device=xp.device)
    wt = w.reshape(w.shape[0] // bk, bk, nNb, bn)
    origins = [((p // mb.spi) * boh * stride, (p % mb.spi) * bow * stride)
               for p in range(bpi)]
    if compact is not None:
        # (B*bpi, rows, cols, Cp): every M-block's window of all channels
        win = torch.stack([xp[:, r0:r0 + rows, q0:q0 + cols] for r0, q0 in origins],
                          dim=1).flatten(0, 1)
        oh = torch.arange(boh, device=xp.device)[:, None, None] * stride
        ow = torch.arange(bow, device=xp.device)[None, :, None] * stride
        for j, r in enumerate(compact.rows.tolist()):
            e = compact.tab[j, :r].to(torch.int64)
            pad = e < 0
            e = e.clamp(min=0)
            # patch row k of output pixel (oh, ow): win[oh*stride + dy_k,
            # ow*stride + dx_k, channel_k]
            pt = win[:, oh + (e >> 8 & 0xFF), ow + (e & 0xFF), e >> 16]
            pt = pt.masked_fill(pad, 0).reshape(n_blocks, boh * bow, r)
            pt = F.pad(pt, (0, 0, 0, bm - boh * bow))
            acc[:, :, j, :] = int_matmul_exact(pt, compact.w[:r, j * bn:(j + 1) * bn])
    by_tile = {} if compact is not None else live_columns_by_tile(idx, cnt)
    for t, js in by_tile.items():
        xc = xp[..., t * cpk:(t + 1) * cpk]
        # (B, bpi, rows, cols, cpk): the window of every M-block
        win = torch.stack([xc[:, r0:r0 + rows, q0:q0 + cols]
                           for r0, q0 in origins], dim=1)
        # tap (dy, dx) of output pixel (oh, ow) is win[oh*stride + dy,
        # ow*stride + dx]
        taps = [win[:, :, dy:dy + (boh - 1) * stride + 1:stride,
                    dx:dx + (bow - 1) * stride + 1:stride, :]
                for dy in range(kx) for dx in range(ky)]
        pt = torch.stack(taps, dim=-1)      # (B, bpi, boh, bow, cpk, kx*ky)
        pt = F.pad(pt, (0, slot - kx * ky))
        pt = pt.reshape(n_blocks, boh * bow, cpk * slot)
        pt = F.pad(pt, (0, bk - cpk * slot, 0, bm - boh * bow))
        wc = wt[t][:, js, :].reshape(bk, len(js) * bn)
        if acc_dtype == torch.int32:
            prod = int_matmul_exact(pt, wc)
        else:
            prod = pt.to(torch.float32) @ wc.to(torch.float32)
        prod = prod.reshape(n_blocks, bm, len(js), bn)
        if activation_dsb:
            hit = (win != 0).reshape(n_blocks, -1).any(dim=1)
            prod = prod * hit.to(prod.dtype)[:, None, None, None]
            skips[:, js] += (~hit).to(torch.int32)[:, None]
        acc[:, :, js, :] += prod
    out = flush_epilogue(acc.reshape(n_blocks * bm, n_total), scale, bias,
                         relu, out_scale).to(out_dtype)
    return (out, skips) if count_skips else out


def implicit_block_sparse_conv(
    xp: torch.Tensor,          # (B, Hp, Wp, nKb*cpk) pad_input() output
    w: torch.Tensor,           # (nKb*bk, nNb*bn) packed weight (f32/bf16/int8)
    idx: torch.Tensor,         # (nNb, max_nnz) int32 live K-tile (= cin-block) ids
    cnt: torch.Tensor,         # (nNb,) int32
    bias: Optional[torch.Tensor] = None,    # (nNb*bn,) fused epilogue bias
    scale: Optional[torch.Tensor] = None,   # (nNb*bn,) fused dequant row (int8)
    out_scale: Optional[torch.Tensor] = None,  # (nNb*bn,) requantize row -> int8
    *,
    kx: int, ky: int, stride: int,
    mb: MBlock,
    block: Tuple[int, int], cpk: int, slot: int,
    relu: bool = False,
    activation_dsb: bool = False,
    count_skips: bool = False,
    compact: Optional[CompactK] = None,   # int8: the bind's compacted K operands
):
    """-> (B*bpi*bm, nNb*bn). M-block ``(b, p)`` starts at row
    ``(b*bpi + p)*bm``; its first ``block_oh*block_ow`` rows are the
    block's output pixels row-major (row band ``p // spi``, column
    segment ``p % spi``), the rest padding — undo with
    :func:`crop_output`.

    int8 operands (``xp``/``w`` are Q-format codes): accumulation is exact
    **int32**, the flush dequantizes through the per-cout ``scale`` row
    (then bias, then ReLU) — output is f32, or int8 codes when the
    requantizing ``out_scale`` row is passed. Same contract as
    :mod:`block_sparse_matmul`.

    ``activation_dsb`` (int8 codes only) skips all-zero windows —
    bit-exact. With ``count_skips`` the return is ``(out, skips)`` where
    ``skips`` is the ``(B*bpi, nNb)`` int32 per-M-block/per-column skip
    counter (skipped live steps; total live steps are
    ``B*bpi*cnt.sum()``).

    ``compact`` (:func:`compact_k` of the same ``w`` and table, taken as
    built): the products run on the compacted K operands, the same codes;
    on the card only where :func:`takes_compact_path` holds, else it
    raises.

    A CUDA ``xp`` launches the CUDA kernel on the current stream (no
    synchronize) or raises; a CPU ``xp`` runs
    :func:`implicit_block_sparse_conv_plain`."""
    if not xp.is_cuda:
        return implicit_block_sparse_conv_plain(
            xp, w, idx, cnt, bias, scale, out_scale, kx=kx, ky=ky,
            stride=stride, mb=mb, block=block, cpk=cpk, slot=slot, relu=relu,
            activation_dsb=activation_dsb, count_skips=count_skips,
            compact=compact)
    rows, cols, nNb = _check_operands(xp, w, idx, cnt, kx, ky, stride, mb,
                                      block, cpk, activation_dsb)
    B, Hp, Wp, Cp = xp.shape
    bk, bn = block
    n_total = w.shape[1]
    if compact is not None and (activation_dsb or xp.dtype != torch.int8):
        raise TypeError("compacted K operands take int8 codes without "
                        "activation_dsb (its skip is decided per K-tile)")
    _, out_dtype = quantized_contract(xp, w, scale, out_scale)
    if xp.dtype not in DTYPE_CODES:
        raise TypeError(f"implicit_block_sparse_conv kernel takes "
                        f"f32/bf16/int8 operands, got {xp.dtype}")
    if mb.bm > KERNEL_MAX_BM or bn > KERNEL_MAX_BN:
        raise ValueError(
            f"implicit_block_sparse_conv kernel takes bm <= {KERNEL_MAX_BM} "
            f"and bn <= {KERNEL_MAX_BN}, got bm={mb.bm}, block={block}")
    if not window_fits_card(rows, cols, cpk):
        raise ValueError(
            f"window ({rows}, {cols}, {cpk}) does not fit a thread block's "
            f"{CARD_SHARED_BYTES} bytes of shared memory — use the "
            "materializing path")
    if compact is not None and not takes_compact_path(rows, cols, Cp):
        raise ValueError(
            f"window ({rows}, {cols}, {Cp}) of all channels does not fit a "
            "block beside the weight ring — compacted K operands need it")
    dev = xp.device
    if compact is not None:
        w = compact.w          # the kernel reads the compacted weight alone
    for name, t in (("w", w), ("idx", idx), ("cnt", cnt)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xp on {dev}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError("idx and cnt must be int32")
    xp, w, idx, cnt = (t.contiguous() for t in (xp, w, idx, cnt))
    scale, bias, out_scale = epilogue_rows(n_total, dev, scale=scale,
                                           bias=bias, out_scale=out_scale)
    n_blocks = B * mb.bpi
    out = torch.empty((n_blocks * mb.bm, n_total), dtype=out_dtype, device=dev)
    skips = (torch.empty((n_blocks, nNb), dtype=torch.int32, device=dev)
             if count_skips else None)
    if n_blocks == 0:
        return (out, skips) if count_skips else out
    resident = compact is not None and takes_resident_path(
        n_blocks, mb.bm, rows * cols * window_pitch(Cp), _sm_count(dev.index),
        compact.k_units)
    ktab, krows = (None, None) if compact is None else (compact.tab, compact.rows)
    lib = _build.load()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.hapm_implicit_block_sparse_conv(
            ptr(xp), ptr(w), ptr(idx), ptr(cnt), ptr(scale), ptr(bias),
            ptr(out_scale), ptr(out), ptr(skips), ptr(ktab), ptr(krows), B, Hp,
            Wp, Cp, n_total, idx.shape[1], kx, ky, stride, mb.block_oh,
            mb.block_ow, mb.spi, mb.bpi, mb.bm, bk, bn, cpk, slot,
            DTYPE_CODES[xp.dtype], int(relu), int(activation_dsb), int(resident),
            w.shape[0] if compact is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "implicit_block_sparse_conv")
    tracing.count(LAUNCHES)
    if resident:
        tracing.count(RESIDENT)
    if compact is not None:
        tracing.count(COMPACT)
    return (out, skips) if count_skips else out
