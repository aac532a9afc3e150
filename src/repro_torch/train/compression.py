"""Gradient compression for cross-host links (optional).

* ``topk_compress`` — keep the k largest-|g| entries per tensor with error
  feedback (Stich et al.): the residual re-enters next step, so convergence
  is preserved while all-reduce volume drops by ~(1 - k/n).
* ``int8_compress`` — per-tensor symmetric int8 quantization with error
  feedback: 4× volume reduction on the gradient all-reduce.

Both are tree transforms applied *before* the optimizer inside the train
step (:func:`repro_torch.train.loop.make_train_step`).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core.masks import tree_map

PyTree = Any


def _pick(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda o: o[i], tree, is_leaf=lambda x: isinstance(x, tuple))


def zeros_like_f32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def topk_compress(grads: PyTree, errors: PyTree, frac: float) -> Tuple[PyTree, PyTree]:
    """Returns (compressed_grads, new_errors). frac = kept fraction."""
    def f(g, e):
        g = g.to(torch.float32) + e
        flat = g.reshape(-1)
        k = max(1, int(frac * flat.shape[0]))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        kept = g * (torch.abs(g) >= thresh).to(torch.float32)
        return kept, g - kept
    out = tree_map(f, grads, errors)
    return _pick(out, 0), _pick(out, 1)


@torch.no_grad()
def int8_compress(grads: PyTree, errors: PyTree) -> Tuple[PyTree, PyTree]:
    """Symmetric per-tensor int8 round-trip with error feedback."""
    def f(g, e):
        g = g.to(torch.float32) + e
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127)
        deq = q * scale
        return deq, g - deq
    out = tree_map(f, grads, errors)
    return _pick(out, 0), _pick(out, 1)
