"""Uniform gradual magnitude pruning — the paper's baseline (its ref. [4]).

Zhu & Gupta, "To prune, or not to prune" (arXiv:1710.01878): per-layer
unstructured magnitude pruning with the cubic sparsity ramp

    s_t = s_f + (s_i - s_f) * (1 - (t - t0) / (n * dt))**3,  t0 <= t <= t0 + n*dt

applied every ``dt`` steps. The paper prunes every layer to the same target
(80 %), i.e. *uniform* per-layer sparsity — zeros land wherever magnitude is
lowest, with no hardware-schedule alignment (which is exactly why the DSB
barely helps it).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .masks import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class UniformPruneConfig:
    target_sparsity: float = 0.8     # paper model 3
    initial_sparsity: float = 0.0
    begin_step: int = 0
    end_step: int = 10000
    update_every: int = 100


def sparsity_at(step: int, cfg: UniformPruneConfig) -> float:
    """Cubic ramp; a host-side scalar schedule."""
    if step < cfg.begin_step:
        return 0.0
    span = max(cfg.end_step - cfg.begin_step, 1)
    frac = min(max((step - cfg.begin_step) / span, 0.0), 1.0)
    return cfg.target_sparsity + (cfg.initial_sparsity - cfg.target_sparsity) * (1.0 - frac) ** 3


def magnitude_masks(params: PyTree, masks: PyTree, sparsity: float) -> PyTree:
    """Recompute per-layer magnitude masks at ``sparsity``. Pruned weights are
    zero-valued (masked after every optimizer step) so monotonicity is
    automatic: they sit at the bottom of the magnitude order."""

    def f(p, m):
        if m is None:
            return None
        flat = torch.abs(p.reshape(-1))
        n = flat.shape[0]
        # the count rounds like the JAX package's: the f32 value, half to even
        k = int(np.round(np.float32(sparsity * n)))
        # threshold = k-th smallest |w|; a stable sort breaks ties by index,
        # so exactly k entries are pruned
        order = torch.argsort(flat, stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(n, device=order.device)
        return (ranks >= k).to(torch.float32).reshape(p.shape)

    return tree_map(f, params, masks, is_leaf=lambda x: x is None)


def maybe_update(step: int, params: PyTree, masks: PyTree, cfg: UniformPruneConfig) -> PyTree:
    """Host-side schedule: recompute masks on schedule boundaries."""
    if step < cfg.begin_step or step > cfg.end_step:
        return masks
    if (step - cfg.begin_step) % cfg.update_every != 0:
        return masks
    return magnitude_masks(params, masks, sparsity_at(step, cfg))
