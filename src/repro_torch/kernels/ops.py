"""Public wrappers around the kernels: shape normalization (leading batch
dims, M-padding) and bind-time constants.

The kernel-vs-plain switch lives in the kernels' own wrappers and has one
rule: a CUDA tensor launches the CUDA kernel (or raises), a CPU tensor
runs the plain PyTorch version. Nothing else decides it.

This slice of the port carries the **forward** closures only; the
backward twins (transposed-plan dX, live-tile dW) arrive with the training
slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..sparse.block_mask import BlockSparsePlan
from .block_sparse_matmul import block_sparse_matmul


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


def make_block_sparse_matmul(plan: BlockSparsePlan, tile_mask: np.ndarray, *,
                             bm: int = 128, bias=None, relu: bool = False,
                             scale=None, out_scale=None):
    """Build ``f(x, w) -> x @ (w ⊙ mask)`` for a *fixed* pruning plan
    (rebuilt when HAPM prunes more groups — an epoch-boundary event).

    ``bias`` (a length-N vector in the *packed* column layout) and/or
    ``relu`` fuse the inference epilogue into the kernel's flush step.
    ``scale`` (same packed column layout) is the int8 dequant row: pass it
    together with int8 code operands and the kernel accumulates in int32,
    flushing ``acc * scale (+ bias) (relu)`` as f32. ``out_scale``
    additionally requantizes the flush to int8 Q-format codes (streamed
    activations). Forward only; ``tile_mask`` is what the backward twin
    derives its transposed plan from and is unused until it is ported.
    """
    if out_scale is not None and not (bias is not None or relu
                                      or scale is not None):
        raise ValueError(
            "out_scale requires the epilogue path (scale/bias/relu)")
    tables = DeviceTables(idx=np.asarray(plan.idx, np.int32),
                          cnt=np.asarray(plan.cnt, np.int32),
                          bias=_row(bias), scale=_row(scale),
                          out_scale=_row(out_scale))
    block = plan.block

    def f(x, w):
        t = tables.on(x.device)
        lead = x.shape[:-1]
        xp, M = _pad_rows(x.reshape(-1, x.shape[-1]), bm)
        out = block_sparse_matmul(xp, w, t["idx"], t["cnt"], t["bias"],
                                  t["scale"], t["out_scale"], block=block,
                                  bm=bm, relu=relu)[:M]
        return out.reshape(*lead, w.shape[1])

    return f
