"""Public wrappers around the kernels: shape normalization (leading batch
dims, M-padding), bind-time constants, and ``torch.autograd.Function``s so
the kernels compose with autograd (the JAX package's ``custom_vjp``s).

The kernel-vs-plain switch lives in the kernels' own wrappers and has one
rule: a CUDA tensor launches the CUDA kernel (or raises), a CPU tensor
runs the plain PyTorch version. Nothing else decides it — a backward never
falls through to autograd of the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import quant as Q
from ..sparse.block_mask import (BlockSparsePlan, plan_from_tile_mask,
                                 transpose_plan)
from .block_sparse_matmul import (block_sparse_grad_weight, block_sparse_matmul,
                                  grad_weight_stacks)
from .int8_matmul import int8_matmul


def _pad_rows(x2d: torch.Tensor, bm: int):
    M = x2d.shape[0]
    Mp = -(-M // bm) * bm
    if Mp != M:
        x2d = F.pad(x2d, (0, 0, 0, Mp - M))
    return x2d, M


class DeviceTables:
    """Bind-time host arrays (dispatch table, epilogue rows) placed on the
    device of the first call and kept there."""

    def __init__(self, **host):
        self._host = host
        self._dev: dict = {}

    def on(self, device):
        hit = self._dev.get(device)
        if hit is None:
            hit = {k: (None if v is None else torch.as_tensor(v).to(device))
                   for k, v in self._host.items()}
            self._dev[device] = hit
        return hit


def _row(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def make_block_sparse_grad_weight(tile_mask: np.ndarray,
                                  block: Tuple[int, int], *, bm: int = 128,
                                  g_lanes: Optional[int] = None):
    """Build ``dw_fn(x2d, g2d) -> x2d^T @ g2d`` on the live tiles of
    ``tile_mask`` only (:func:`block_sparse_grad_weight`), scattered back
    onto the full packed ``(K, N)`` grid with pruned tiles *exactly* zero —
    the dW half of every block-sparse backward. Operands are cast to f32;
    rows of ``x2d`` / ``g2d`` are zero-padded to the ``bm`` multiple (zero
    rows contribute nothing to the product). ``g_lanes``: the caller's
    promise that ``g2d`` is zero past that many lanes of every bn-lane
    column (a conv layout's ``output_lanes``); the kernel then reads none of
    them. With no live tile the kernel is not launched and the result is
    all zeros."""
    tm = np.asarray(tile_mask)
    live = np.argwhere(tm)
    nKb, nNb = tm.shape
    bk, bn = block
    tables = DeviceTables(kk=live[:, 0].astype(np.int32),
                          nn=live[:, 1].astype(np.int32),
                          stacks=grad_weight_stacks(live[:, 0], live[:, 1], bk))

    def dw_fn(x2d, g2d):
        if live.shape[0] == 0:
            return torch.zeros((nKb * bk, nNb * bn), dtype=torch.float32,
                               device=x2d.device)
        t = tables.on(x2d.device)
        xp, _ = _pad_rows(x2d.to(torch.float32), bm)
        gp, _ = _pad_rows(g2d.to(torch.float32), bm)
        compact = block_sparse_grad_weight(xp, gp, t["kk"], t["nn"],
                                           block=(bk, bn), bm=bm,
                                           stacks=t["stacks"], g_lanes=g_lanes)
        dw = torch.zeros((nKb, nNb, bk, bn), dtype=compact.dtype,
                         device=compact.device)
        dw[t["kk"].long(), t["nn"].long()] = compact
        return dw.permute(0, 2, 1, 3).reshape(nKb * bk, nNb * bn)

    return dw_fn


class KernelVJP(torch.autograd.Function):
    """A differentiable function of ``(x, w)`` made of kernels: ``fns =
    (forward(x, w), backward(x, w, g, want_dx, want_dw) -> (dx, dw))`` —
    the counterpart of the JAX package's ``custom_vjp``s. The backward
    computes only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, x, w, fns):
        ctx.fns = fns
        ctx.save_for_backward(x, w)
        return fns[0](x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = ctx.fns[1](x, w, g.contiguous(), *ctx.needs_input_grad[:2])
        return dx, dw, None


class _BoundBlockSparseMatmul:
    """The plans of one trainable block-sparse matmul: the forward table,
    the transposed table for dX, the live-tile list for dW. ``g_lanes``: the
    caller's promise that the output gradient is zero past that many lanes of
    every bn-lane column (a conv layout's ``output_lanes``); both backward
    kernels then read none of them (``x_lanes`` of the dX, ``g_lanes`` of the
    dW)."""

    def __init__(self, plan: BlockSparsePlan, tile_mask: np.ndarray, bm: int,
                 g_lanes: Optional[int] = None):
        t_plan = transpose_plan(plan, np.asarray(tile_mask))
        self.block, self.t_block, self.bm = plan.block, t_plan.block, bm
        self.g_lanes = g_lanes
        self.tables = DeviceTables(idx=np.asarray(plan.idx, np.int32),
                                   cnt=np.asarray(plan.cnt, np.int32),
                                   t_idx=np.asarray(t_plan.idx, np.int32),
                                   t_cnt=np.asarray(t_plan.cnt, np.int32))
        self.dw_fn = make_block_sparse_grad_weight(tile_mask, plan.block,
                                                   bm=bm, g_lanes=g_lanes)

    def forward(self, x, w):
        t = self.tables.on(x.device)
        lead = x.shape[:-1]
        xp, M = _pad_rows(x.reshape(-1, x.shape[-1]), self.bm)
        out = block_sparse_matmul(xp, w, t["idx"], t["cnt"], block=self.block,
                                  bm=self.bm)[:M]
        return out.reshape(*lead, w.shape[1])

    def backward(self, x, w, g, want_dx, want_dw):
        g2d = g.reshape(-1, w.shape[1])
        dx = dw = None
        if want_dx:
            t = self.tables.on(g.device)
            gp, M = _pad_rows(g2d, self.bm)
            dx = block_sparse_matmul(gp, w.t().contiguous(), t["t_idx"],
                                     t["t_cnt"], block=self.t_block,
                                     bm=self.bm, x_lanes=self.g_lanes)[:M]
            dx = dx.reshape(x.shape).to(x.dtype)
        if want_dw:
            dw = self.dw_fn(x.reshape(-1, x.shape[-1]), g2d).to(w.dtype)
        return dx, dw


def make_block_sparse_matmul(plan: BlockSparsePlan, tile_mask: np.ndarray, *,
                             bm: int = 128, bias=None, relu: bool = False,
                             scale=None, out_scale=None):
    """Build ``f(x, w) -> x @ (w ⊙ mask)`` for a *fixed* pruning plan
    (rebuilt when HAPM prunes more groups — an epoch-boundary event).
    Backward (a ``torch.autograd.Function``):

      dx = dy @ (w ⊙ m)^T   — block-sparse with the transposed plan
      dw = x^T dy           — live tiles only (:func:`block_sparse_grad_weight`),
                              pruned tiles exactly zero by construction

    ``bias`` (a length-N vector in the *packed* column layout) and/or
    ``relu`` fuse the inference epilogue into the kernel's flush step;
    that variant is forward-only (no backward) — it exists for the
    folded-BN inference path, not training. ``scale`` (same packed column
    layout) is the int8 dequant row: pass it together with int8 code
    operands and the kernel accumulates in int32, flushing
    ``acc * scale (+ bias) (relu)`` as f32 — also forward-only.
    ``out_scale`` additionally requantizes the flush to int8 Q-format
    codes (streamed activations).
    """
    if bias is not None or relu or scale is not None:
        tables = DeviceTables(idx=np.asarray(plan.idx, np.int32),
                              cnt=np.asarray(plan.cnt, np.int32),
                              bias=_row(bias), scale=_row(scale),
                              out_scale=_row(out_scale))
        block = plan.block

        def f_epilogue(x, w):
            t = tables.on(x.device)
            lead = x.shape[:-1]
            xp, M = _pad_rows(x.reshape(-1, x.shape[-1]), bm)
            out = block_sparse_matmul(xp, w, t["idx"], t["cnt"], t["bias"],
                                      t["scale"], t["out_scale"], block=block,
                                      bm=bm, relu=relu)[:M]
            return out.reshape(*lead, w.shape[1])

        return f_epilogue

    if out_scale is not None:
        raise ValueError(
            "out_scale requires the epilogue path (scale/bias/relu)")
    op = _BoundBlockSparseMatmul(plan, tile_mask, bm)
    fns = (op.forward, op.backward)

    def f(x, w):
        return KernelVJP.apply(x, w, fns)

    return f


def fixed_point_matmul(
    x: torch.Tensor,                # (..., K) float
    w: torch.Tensor,                # (K, N) float
    x_fmt: Q.QFormat = Q.Q3_4,
    w_fmt: Q.QFormat = Q.Q2_5,
    *,
    bm: int = 128,
) -> torch.Tensor:
    """Paper-faithful fixed-point GEMM: quantize to integer codes, int8
    matmul (:func:`int8_matmul`, the kernel on a CUDA tensor), scalar
    dequant. Rows are zero-padded to the ``bm`` multiple; ``K`` and ``N``
    must be multiples of the kernel's 128-wide blocks. Straight-through
    gradient, on the float operands: ``dx = g @ wᵀ``, ``dw = x2dᵀ @ g2d``
    (plain matmuls, as the JAX package leaves them outside its kernels)."""
    lead = x.shape[:-1]
    K, N = w.shape

    def forward(x, w):
        xc = Q.to_int8(x, x_fmt).reshape(-1, K)
        wc = Q.to_int8(w, w_fmt)
        xp, M = _pad_rows(xc, bm)
        scale = torch.tensor([1.0 / (x_fmt.scale * w_fmt.scale)],
                             dtype=torch.float32, device=x.device)
        out = int8_matmul(xp, wc, scale, bm=bm)[:M]
        return out.reshape(*lead, N).to(x.dtype)

    def backward(x, w, g, want_dx, want_dw):
        dx = (g @ w.t()).to(x.dtype) if want_dx else None
        dw = ((x.reshape(-1, K).t() @ g.reshape(-1, N)).to(w.dtype)
              if want_dw else None)
        return dx, dw

    return KernelVJP.apply(x, w, (forward, backward))


def block_sparse_from_hapm(w: np.ndarray, element_mask: np.ndarray,
                           block: Tuple[int, int] = (128, 128), *,
                           bm: int = 128):
    """Convenience: HAPM element mask -> plan -> bound (trainable) kernel;
    returns ``(f, plan)``."""
    from ..sparse.block_mask import tile_mask_from_weight
    tm = tile_mask_from_weight(np.asarray(element_mask), block)
    plan = plan_from_tile_mask(tm, block)
    return make_block_sparse_matmul(plan, tm, bm=bm), plan
