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
  product is not) and bf16 operands with exact products, both in f32.
- :func:`implicit_block_sparse_conv_plain` — the same function in plain
  PyTorch on the same packed operands and tables; the CPU path and the
  yardstick the kernel is held to on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

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

_launches = 0


def launch_count() -> int:
    """CUDA launches of this module's kernel since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


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
                    activation_dsb):
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
):
    """The plain PyTorch version of :func:`implicit_block_sparse_conv`: per
    live K-tile it slices every M-block's window out of the padded input,
    forms the patch rows from ``kx·ky`` strided slices of the windows, and
    multiplies them with the weight tiles of the output columns that visit
    the tile — f32 (int32 for codes) accumulation in ascending tile order,
    all-zero windows masked out under ``activation_dsb``, then the shared
    epilogue."""
    rows, cols, nNb = _check_operands(xp, w, idx, cnt, kx, ky, stride, mb,
                                      block, cpk, activation_dsb)
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
    for t, js in live_columns_by_tile(idx, cnt).items():
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

    A CUDA ``xp`` launches the CUDA kernel on the current stream (no
    synchronize) or raises; a CPU ``xp`` runs
    :func:`implicit_block_sparse_conv_plain`."""
    if not xp.is_cuda:
        return implicit_block_sparse_conv_plain(
            xp, w, idx, cnt, bias, scale, out_scale, kx=kx, ky=ky,
            stride=stride, mb=mb, block=block, cpk=cpk, slot=slot, relu=relu,
            activation_dsb=activation_dsb, count_skips=count_skips)
    global _launches
    rows, cols, nNb = _check_operands(xp, w, idx, cnt, kx, ky, stride, mb,
                                      block, cpk, activation_dsb)
    B, Hp, Wp, Cp = xp.shape
    bk, bn = block
    n_total = w.shape[1]
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
    dev = xp.device
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
    lib = _build.load()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.hapm_implicit_block_sparse_conv(
            ptr(xp), ptr(w), ptr(idx), ptr(cnt), ptr(scale), ptr(bias),
            ptr(out_scale), ptr(out), ptr(skips), B, Hp, Wp, Cp, n_total,
            idx.shape[1], kx, ky, stride, mb.block_oh, mb.block_ow, mb.spi,
            mb.bpi, mb.bm, bk, bn, cpk, slot, DTYPE_CODES[xp.dtype],
            int(relu), int(activation_dsb),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "implicit_block_sparse_conv")
    _launches += 1
    return (out, skips) if count_skips else out
