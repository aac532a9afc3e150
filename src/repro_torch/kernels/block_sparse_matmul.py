"""Block-sparse matmul — the Dynamic Sparsity Bypass as a GPU kernel.

``out[i-blk, j-blk] = epilogue(Σ_{s<cnt[j]} x[i-blk, idx[j,s]-tile] @
w[idx[j,s]-tile, j-blk])``: an ``(nNb, max_nnz)`` index table (from
:mod:`repro_torch.sparse.block_mask`) lists the live K-tiles of each output
column, so pruned tiles cost neither arithmetic nor loads.

Operands are f32/bf16 (f32 accumulation) **or int8 codes** — the paper's
Q3.4 × Q2.5 fixed point. int8 operands accumulate in **int32** (exact,
bit-identical to the reference) and require a ``scale`` row.

Optional fused epilogue at the flush, in dequant → bias → ReLU →
requantize order: a per-column ``scale`` multiply (f32 ``(N,)`` row), a
per-column ``bias`` add, ``relu``, and an optional per-column ``out_scale``
row that requantizes the flushed value back to int8 Q-format codes
(``round_sat(out * out_scale, 127)``, round-half-even). Fully-pruned
columns still flush ``bias`` (then ReLU), matching the dense
``conv(x, 0) + b`` semantics.

Two implementations of the one function live here:

- :func:`block_sparse_matmul` — the wrapper. For a CUDA tensor it launches
  the hand-written kernel ``csrc/block_sparse_matmul.cu`` (or raises): both
  its instances, int8 codes and f32/bf16 operands, multiply on the tensor
  cores. For a CPU tensor, and only then, it runs the plain version.
- :func:`block_sparse_matmul_plain` — the same function in plain PyTorch:
  same packed operands and tables, same epilogue order, a loop over live
  tiles. It is the CPU path and the yardstick the kernel is held to on the
  card; nothing on a CUDA serving path calls it.

Its backward twin, the live-tile weight gradient ``dW[l] = x[:, kk[l]-tile]ᵀ
@ g[:, nn[l]-tile]``, lives here too, in the same two forms:
:func:`block_sparse_grad_weight` (kernel ``csrc/block_sparse_grad_weight.cu``
on a CUDA tensor) and :func:`block_sparse_grad_weight_plain`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..core.quant import round_sat
from . import _build
from .ref import int_matmul_exact

# int8 symmetric code bound: requantizing epilogues clamp to ±127 (both
# Q2.5 and Q3.4 share it — the sign bit plus 7 magnitude bits of an int8)
INT8_MAX_CODE = 127.0

# limits of the CUDA kernels' output tile: 128 rows (8 warps of m16 rows, or
# 16 x 16 threads of up to 8 rows each) by 128 lanes
KERNEL_MAX_BM = 128
KERNEL_MAX_BN = 128

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the weight-gradient kernel runs one block per stack of up to
# GRAD_W_STACK_ROWS // bk live tiles of one output column (their x columns
# side by side as the tensor cores' 128 rows) and row chunk; it splits the
# rows into chunks of a multiple of its 32-row staging step, enough chunks
# for about GRAD_W_BLOCKS_PER_SM blocks on each SM of the device it runs on,
# but none shorter than GRAD_W_MIN_CHUNK rows
GRAD_W_STACK_ROWS = 128
GRAD_W_SLICE_M = 32
GRAD_W_BLOCKS_PER_SM = 2
GRAD_W_MIN_CHUNK = 128

LAUNCHES = "kernel.block_sparse_matmul.launches"
GRAD_W_LAUNCHES = "kernel.block_sparse_grad_weight.launches"


# --- shared epilogue contract (also consumed by kernels.implicit_conv) ----

def quantized_contract(x, w, scale, out_scale=None):
    """-> (acc_dtype, out_dtype) for the operand dtypes, validating the
    int8-code contract: int8 × int8 accumulates exactly in int32 and
    needs a dequant ``scale`` row to emit float output; an ``out_scale``
    row requantizes the flush so the kernel emits int8 codes instead."""
    if x.dtype == torch.int8:
        if w.dtype != torch.int8:
            raise TypeError("int8 x needs int8 w (codes × codes)")
        if scale is None:
            raise ValueError(
                "int8 operands accumulate integer codes — pass the dequant "
                "scale row so the flush epilogue can emit float output")
        return torch.int32, (torch.int8 if out_scale is not None
                             else torch.float32)
    if out_scale is not None:
        raise ValueError(
            "the requantizing epilogue (out_scale) is part of the int8-code "
            "contract — f32 operands flush f32")
    if w.dtype != x.dtype:
        raise TypeError(f"operand dtypes differ: {x.dtype} vs {w.dtype}")
    return torch.float32, x.dtype


def flush_epilogue(acc, scale, bias, relu, out_scale=None):
    """dequant → bias → ReLU on the flushed accumulator, f32; with
    ``out_scale`` the result is requantized to int8 codes
    (``round_sat(out * out_scale, 127)``, round-half-even). Rows broadcast
    over the accumulator's last axis."""
    out = acc
    if scale is not None:           # int8 path: dequant the int32 acc
        out = out.to(torch.float32) * scale
    if bias is not None:
        out = out.to(torch.float32) + bias.to(torch.float32)
    if relu:
        out = torch.clamp(out, min=0.0)
    if out_scale is not None:       # requantize: emit Q-format codes
        out = round_sat(out * out_scale, INT8_MAX_CODE)
    return out


def epilogue_rows(n: int, device, **rows):
    """Validate the optional ``(N,)`` epilogue rows and return them as
    contiguous f32 tensors on ``device`` (``None`` stays ``None``)."""
    out = []
    for name, row in rows.items():
        if row is not None:
            if tuple(row.shape) != (n,):
                raise ValueError(
                    f"{name} must be ({n},), got {tuple(row.shape)}")
            row = row.to(device=device, dtype=torch.float32).contiguous()
        out.append(row)
    return out


def live_columns_by_tile(idx, cnt):
    """{K-tile id: [output columns j that visit it]} from the dispatch
    table, tiles in ascending order (host-side)."""
    # a read of the device's table waits for the device; a CPU table is no read
    with tracing.span("host.sync", what="live_columns_by_tile") if idx.is_cuda else tracing.OFF:
        idx_h = idx.detach().cpu().numpy()
        cnt_h = cnt.detach().cpu().numpy()
    by_tile: dict = {}
    for j in range(idx_h.shape[0]):
        for s in range(int(cnt_h[j])):
            by_tile.setdefault(int(idx_h[j, s]), []).append(j)
    return dict(sorted(by_tile.items()))


def _check_operands(x, w, idx, cnt, block, bm):
    M, K = x.shape
    Kw, N = w.shape
    bk, bn = block
    if not (Kw == K and K % bk == 0 and N % bn == 0 and M % bm == 0):
        raise ValueError(
            f"shapes must be tile-aligned: {tuple(x.shape)} @ "
            f"{tuple(w.shape)}, block={block}, bm={bm}")
    if not (idx.dim() == 2 and idx.shape[0] == N // bn
            and tuple(cnt.shape) == (N // bn,)):
        raise ValueError(
            f"dispatch table off-grid: idx {tuple(idx.shape)}, cnt "
            f"{tuple(cnt.shape)} for {N // bn} column tiles")
    return M, K, N, bk, bn


def _lane_count(name: str, lanes, width: int) -> int:
    """A caller's promise that an operand is zero past ``lanes`` lanes of
    every ``width``-lane tile: the count (default: all), refused outside
    1..width."""
    n = width if lanes is None else int(lanes)
    if not 1 <= n <= width:
        raise ValueError(f"{name} must be in 1..{width}, got {lanes}")
    return n


def block_sparse_matmul_plain(
    x: torch.Tensor,            # (M, K) f32/bf16, or int8 codes
    w: torch.Tensor,            # (K, N) same family as x
    idx: torch.Tensor,          # (nNb, max_nnz) int32
    cnt: torch.Tensor,          # (nNb,) int32
    bias: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    out_scale: Optional[torch.Tensor] = None,
    *,
    block: Tuple[int, int] = (128, 128),
    bm: int = 128,
    relu: bool = False,
    x_lanes: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`block_sparse_matmul`: for every
    live K-tile, one product of the tile's x columns with the weight tiles
    of the output columns that visit it, accumulated in f32 (int32 for
    codes) in ascending tile order, then the shared epilogue. With
    ``x_lanes`` only the first ``x_lanes`` columns of each tile and the same
    rows of its weights are multiplied: the same function for an ``x`` that
    is zero past them."""
    M, K, N, bk, bn = _check_operands(x, w, idx, cnt, block, bm)
    lanes = _lane_count("x_lanes", x_lanes, bk)
    acc_dtype, out_dtype = quantized_contract(x, w, scale, out_scale)
    scale, bias, out_scale = epilogue_rows(N, x.device, scale=scale, bias=bias,
                                           out_scale=out_scale)
    nNb = N // bn
    acc = torch.zeros((M, nNb, bn), dtype=acc_dtype, device=x.device)
    wt = w.reshape(K // bk, bk, nNb, bn)
    for t, cols in live_columns_by_tile(idx, cnt).items():
        xt = x[:, t * bk:t * bk + lanes]
        wc = wt[t][:lanes, cols, :].reshape(lanes, len(cols) * bn)
        if acc_dtype == torch.int32:
            prod = int_matmul_exact(xt, wc)
        else:
            prod = xt.to(torch.float32) @ wc.to(torch.float32)
        acc[:, cols, :] += prod.reshape(M, len(cols), bn)
    out = flush_epilogue(acc.reshape(M, N), scale, bias, relu, out_scale)
    return out.to(out_dtype)


def block_sparse_matmul(
    x: torch.Tensor,            # (M, K) f32/bf16, or int8 codes
    w: torch.Tensor,            # (K, N) same family as x
    idx: torch.Tensor,          # (nNb, max_nnz) int32
    cnt: torch.Tensor,          # (nNb,) int32
    bias: Optional[torch.Tensor] = None,   # (N,) fused epilogue bias (f32 units)
    scale: Optional[torch.Tensor] = None,  # (N,) fused dequant row (f32)
    out_scale: Optional[torch.Tensor] = None,  # (N,) requantize row -> int8
    *,
    block: Tuple[int, int] = (128, 128),
    bm: int = 128,
    relu: bool = False,
    x_lanes: Optional[int] = None,         # x is zero past these lanes of a K-tile
) -> torch.Tensor:
    """-> (M, N). A CUDA ``x`` launches the CUDA kernel on the current
    stream (no synchronize) or raises; a CPU ``x`` runs
    :func:`block_sparse_matmul_plain`. ``x_lanes`` (default: all ``bk``) is
    the caller's promise that ``x`` is zero past that many lanes of every
    ``bk``-lane K-tile, as the packed output gradient of a conv layout is
    past its ``output_lanes`` (the dX on the transposed plan): the f32/bf16
    kernel then reads and multiplies none of them. The int8 kernel reads
    every lane and multiplies only the 8-lane output groups and 32-row K
    steps whose weight codes it finds nonzero, which gives the same sums."""
    if not x.is_cuda:
        return block_sparse_matmul_plain(x, w, idx, cnt, bias, scale,
                                         out_scale, block=block, bm=bm,
                                         relu=relu, x_lanes=x_lanes)
    M, K, N, bk, bn = _check_operands(x, w, idx, cnt, block, bm)
    lanes = _lane_count("x_lanes", x_lanes, bk)
    _, out_dtype = quantized_contract(x, w, scale, out_scale)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"block_sparse_matmul kernel takes f32/bf16/int8 "
                        f"operands, got {x.dtype}")
    if bm > KERNEL_MAX_BM or bn > KERNEL_MAX_BN:
        raise ValueError(
            f"block_sparse_matmul kernel takes bm <= {KERNEL_MAX_BM} and "
            f"bn <= {KERNEL_MAX_BN}, got bm={bm}, block={block}")
    dev = x.device
    for name, t in (("w", w), ("idx", idx), ("cnt", cnt)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if idx.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError("idx and cnt must be int32")
    x, w, idx, cnt = (t.contiguous() for t in (x, w, idx, cnt))
    scale, bias, out_scale = epilogue_rows(N, dev, scale=scale, bias=bias,
                                           out_scale=out_scale)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out
    lib = _build.load()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.hapm_block_sparse_matmul(
            ptr(x), ptr(w), ptr(idx), ptr(cnt), ptr(scale), ptr(bias),
            ptr(out_scale), ptr(out), M, K, N, bm, bk, bn, idx.shape[1],
            DTYPE_CODES[x.dtype], int(relu), lanes,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "block_sparse_matmul")
    tracing.count(LAUNCHES)
    return out


# --- the backward twin: live-tile weight gradient --------------------------

def _check_grad_operands(x, g, kk, nn, block, bm):
    M, K = x.shape
    Mg, N = g.shape
    bk, bn = block
    if not (Mg == M and M % bm == 0 and K % bk == 0 and N % bn == 0):
        raise ValueError(
            f"shapes must be tile-aligned: {tuple(x.shape)}, {tuple(g.shape)}, "
            f"block={block}, bm={bm}")
    L = int(kk.shape[0])
    if kk.dim() != 1 or tuple(nn.shape) != (L,):
        raise ValueError(f"live-tile coordinates must be two (L,) vectors, got "
                         f"kk {tuple(kk.shape)}, nn {tuple(nn.shape)}")
    if L == 0:
        raise ValueError("no live tiles — the caller short-circuits to zeros")
    if g.dtype != x.dtype:
        raise TypeError(f"operand dtypes differ: {x.dtype} vs {g.dtype}")
    return M, K, N, bk, bn, L


def stack_width(bk: int) -> int:
    """Live tiles of ``bk`` rows in one stack of the weight-gradient kernel."""
    if bk < 1:
        raise ValueError(f"bk must be positive, got {bk}")
    return max(1, GRAD_W_STACK_ROWS // bk)


def grad_weight_stacks(kk, nn, bk: int) -> np.ndarray:
    """The weight-gradient kernel's stack table for live tiles ``(kk[l],
    nn[l])``: an ``(n_stacks, stack_width(bk))`` int32 array whose
    row lists the indices ``l`` of up to that many live tiles of one output
    column, ``-1`` past the last. Columns come in ascending order, the tiles
    of a column in the caller's order; every tile stands in exactly one row.
    A function of ``(kk, nn, bk)`` alone, built on the host once per bind."""
    width = stack_width(bk)
    kk, nn = np.asarray(kk).reshape(-1), np.asarray(nn).reshape(-1)
    if kk.shape != nn.shape:
        raise ValueError(f"kk {kk.shape} and nn {nn.shape} differ")
    rows = []
    for n in np.unique(nn):
        ls = np.flatnonzero(nn == n)
        for i in range(0, len(ls), width):
            part = ls[i:i + width]
            rows.append(np.pad(part, (0, width - len(part)), constant_values=-1))
    return np.asarray(rows, np.int32).reshape(-1, width)


def grad_weight_split(M: int, n_stacks: int, n_sms: int) -> Tuple[int, int]:
    """(S, chunk): the fixed split of the M rows the weight-gradient kernel
    reduces over, for ``n_stacks`` stacks (:func:`grad_weight_stacks`) on a
    device with ``n_sms`` SMs — S chunks of ``chunk`` rows (a multiple of
    the kernel's 32-row step), the last one short, so that ``n_stacks * S``
    blocks come to about GRAD_W_BLOCKS_PER_SM an SM. A function of the shape
    and the device alone, so two launches on the same inputs sum in the
    same order."""
    target = GRAD_W_BLOCKS_PER_SM * n_sms
    s = max(1, min(-(-target // n_stacks), -(-M // GRAD_W_MIN_CHUNK)))
    chunk = -(-(-(-M // s)) // GRAD_W_SLICE_M) * GRAD_W_SLICE_M
    return -(-M // chunk), chunk


def block_sparse_grad_weight_plain(
    x: torch.Tensor,            # (M, K) f32/bf16 packed patches
    g: torch.Tensor,            # (M, N) f32/bf16 packed output gradient
    kk: torch.Tensor,           # (L,) int32 live-tile K coordinates
    nn: torch.Tensor,           # (L,) int32 live-tile N coordinates
    *,
    block: Tuple[int, int] = (128, 128),
    bm: int = 128,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`block_sparse_grad_weight`: per
    distinct output tile column, one f32 product of the live tiles' x
    columns with that column's g block."""
    M, K, N, bk, bn, L = _check_grad_operands(x, g, kk, nn, block, bm)
    xt = x.to(torch.float32).reshape(M, K // bk, bk)
    gt = g.to(torch.float32).reshape(M, N // bn, bn)
    out = torch.empty((L, bk, bn), dtype=torch.float32, device=x.device)
    by_col: dict = {}
    for l, (k, n) in enumerate(zip(kk.tolist(), nn.tolist())):
        by_col.setdefault(int(n), []).append((l, int(k)))
    for n, items in sorted(by_col.items()):
        ls = [l for l, _ in items]
        ks = [k for _, k in items]
        xs = xt[:, ks, :].reshape(M, len(ks) * bk)
        out[ls] = (xs.T @ gt[:, n, :]).reshape(len(ks), bk, bn)
    return out


def block_sparse_grad_weight(
    x: torch.Tensor,            # (M, K) f32/bf16 packed patches
    g: torch.Tensor,            # (M, N) f32/bf16 packed output gradient
    kk: torch.Tensor,           # (L,) int32 live-tile K coordinates
    nn: torch.Tensor,           # (L,) int32 live-tile N coordinates
    *,
    block: Tuple[int, int] = (128, 128),
    bm: int = 128,
    stacks: Optional[torch.Tensor] = None,  # grad_weight_stacks(kk, nn, bk)
    g_lanes: Optional[int] = None,          # g is zero past these lanes of a column
) -> torch.Tensor:
    """``dW = x^T @ g`` restricted to the live weight tiles — the backward
    twin of :func:`block_sparse_matmul`. Returns the **compact** ``(L, bk,
    bn)`` f32 stack of live dW tiles (``(kk, nn)`` in any order, f32
    accumulation); the caller scatters it onto the full ``(K, N)`` grid,
    so pruned tiles stay exactly zero. ``M`` must be a multiple of ``bm``
    (the caller zero-pads rows); ``L == 0`` is refused — the caller
    short-circuits to zeros.

    A CUDA ``x`` launches the CUDA kernel on the current stream (no
    synchronize) or raises; a CPU ``x`` runs
    :func:`block_sparse_grad_weight_plain`. The kernel multiplies the live
    tiles of an output column together, by the stack table ``stacks``
    (:func:`grad_weight_stacks` of the same ``kk``, ``nn``, on ``x``'s
    device): a bind builds it once; without it the call builds it from a
    host copy of ``kk`` and ``nn``. ``g_lanes`` (default: all ``bn``) is the
    caller's promise that ``g`` is zero past that many lanes of every
    ``bn``-lane column, as a conv layout's packed output gradient is past
    its ``output_lanes``: the kernel reads none of those lanes and their dW
    is 0, which is what the plain version computes from such a ``g``. The
    kernel's sum over rows has a fixed order (:func:`grad_weight_split`):
    two launches on the same inputs give the same bits."""
    if not x.is_cuda:
        return block_sparse_grad_weight_plain(x, g, kk, nn, block=block, bm=bm)
    M, K, N, bk, bn, L = _check_grad_operands(x, g, kk, nn, block, bm)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_sparse_grad_weight kernel takes f32/bf16 "
                        f"operands, got {x.dtype}")
    if bk > KERNEL_MAX_BM or bn > KERNEL_MAX_BN:
        raise ValueError(
            f"block_sparse_grad_weight kernel takes bk <= {KERNEL_MAX_BM} and "
            f"bn <= {KERNEL_MAX_BN}, got block={block}")
    dev = x.device
    for name, t in (("g", g), ("kk", kk), ("nn", nn)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if kk.dtype != torch.int32 or nn.dtype != torch.int32:
        raise TypeError("kk and nn must be int32")
    lanes = _lane_count("g_lanes", g_lanes, bn)
    width = stack_width(bk)
    if stacks is not None and (
            stacks.device != dev or stacks.dtype != torch.int32
            or stacks.dim() != 2 or stacks.shape[1] != width
            or not 1 <= stacks.shape[0] <= L):
        raise ValueError(
            f"stacks must be an int32 (n_stacks <= {L}, {width}) table on {dev} "
            f"(grad_weight_stacks), got {tuple(stacks.shape)} {stacks.dtype} "
            f"on {stacks.device}")
    out = torch.empty((L, bk, bn), dtype=torch.float32, device=dev)
    if M == 0:
        return out.zero_()
    if stacks is None:
        with tracing.span("host.sync", what="grad_weight_stacks"):
            kk_h, nn_h = kk.cpu().numpy(), nn.cpu().numpy()
        stacks = torch.from_numpy(grad_weight_stacks(kk_h, nn_h, bk)).to(dev)
    x, g, kk, nn, stacks = (t.contiguous() for t in (x, g, kk, nn, stacks))
    n_stacks = stacks.shape[0]
    S, chunk = grad_weight_split(
        M, n_stacks, torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = (torch.empty((S, L, bk, bn), dtype=torch.float32, device=dev)
          if S > 1 else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.hapm_block_sparse_grad_weight(
            x.data_ptr(), g.data_ptr(), kk.data_ptr(), nn.data_ptr(),
            stacks.data_ptr(), None if ws is None else ws.data_ptr(),
            out.data_ptr(), M, K, N, bk, bn, lanes, L, n_stacks, width, S, chunk,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "block_sparse_grad_weight")
    tracing.count(GRAD_W_LAUNCHES)
    return out
