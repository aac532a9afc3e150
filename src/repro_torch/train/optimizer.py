"""Hand-rolled tree optimizers over nested dicts of tensors: SGD-momentum
(the CNN reproduction) and AdamW with f32 master state (LM training), plus
LR schedules including ReduceLROnPlateau (the paper trains with it).

The JAX package's update rules, operation for operation: an optimizer is
an ``(init, update)`` pair, ``update(grads, state, params, lr) ->
(updates, new_state)``, and :func:`apply_updates` adds the updates. Nothing
here records autograd history.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.masks import tree_map

PyTree = Any


def _is_pair(x) -> bool:
    return isinstance(x, tuple)


def _pick(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda o: o[i], tree, is_leaf=_is_pair)


def _zeros_f32(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(p.shape), dtype=dtype, device=p.device)


class SGDState(NamedTuple):
    momentum: PyTree


def sgd(momentum: float = 0.9, nesterov: bool = False, weight_decay: float = 0.0):
    def init(params):
        return SGDState(tree_map(_zeros_f32, params))

    @torch.no_grad()
    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
            m_new = momentum * m + g
            step = (g + momentum * m_new) if nesterov else m_new
            return (-lr * step).to(p.dtype), m_new
        out = tree_map(upd, grads, state.momentum, params)
        return _pick(out, 0), SGDState(_pick(out, 1))

    return init, update


class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          moment_dtype=torch.float32):
    """``moment_dtype=torch.bfloat16`` halves optimizer memory (mu/nu) — the
    DeepSeek-style memory trade; updates still computed in f32."""
    def init(params):
        z = lambda p: _zeros_f32(p, moment_dtype)
        return AdamWState(tree_map(z, params), tree_map(z, params),
                          torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state.count + 1
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)

        def upd(g, mu, nu, p):
            g = g.to(torch.float32)
            mu_new = b1 * mu.to(torch.float32) + (1 - b1) * g
            nu_new = b2 * nu.to(torch.float32) + (1 - b2) * g * g
            b1c, b2c = bc1.to(g.device), bc2.to(g.device)
            step = (mu_new / b1c) / (torch.sqrt(nu_new / b2c) + eps)
            step = step + weight_decay * p.to(torch.float32)
            return ((-lr * step).to(p.dtype), mu_new.to(moment_dtype),
                    nu_new.to(moment_dtype))

        out = tree_map(upd, grads, state.mu, state.nu, params)
        return _pick(out, 0), AdamWState(_pick(out, 1), _pick(out, 2), c)

    return init, update


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u, params, updates)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def lr(step):
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        frac = (step - warmup) / max(total - warmup, 1)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + np.cos(np.pi * min(frac, 1.0))))
    return lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Keras-equivalent: shrink LR when the monitored metric stops improving
    (the paper's training recipe, §IV-A)."""
    base_lr: float
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-5
    best: float = np.inf
    wait: int = 0
    lr: float = 0.0

    def __post_init__(self):
        self.lr = self.base_lr

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-6:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.wait = 0
        return self.lr
