"""Training loop machinery: train-step factory (grad accumulation,
pruning-mask discipline, optional gradient compression), an epoch loop with
HAPM / uniform-pruning callbacks, and the straggler watchdog.

Mask discipline: the loss is evaluated on ``apply_masks(params, masks)``
and differentiated with respect to those masked params, and masks are
re-applied after the optimizer update so pruned weights sit at exactly 0.0
(what the accelerator's DSB and the block-sparse kernels rely on).

PyTorch runs eagerly, so the step is a plain function (the JAX package
jits it); :func:`value_and_grad` is the functional gradient over a tree of
tensors that the JAX code gets from ``jax.value_and_grad``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.masks import (apply_masks, tree_flatten_with_path, tree_map,
                          tree_map_with_path)
from . import compression as C
from .optimizer import apply_updates

PyTree = Any


def value_and_grad(fn: Callable, params: PyTree, *args) -> Tuple[Any, PyTree]:
    """``((loss, aux), grads)`` of ``fn(params, *args) -> (loss, aux)`` with
    respect to every floating-point leaf of ``params`` (a nested dict of
    tensors), like ``jax.value_and_grad(fn, has_aux=True)``. ``params`` is
    not modified; leaves the loss does not reach get zero gradients.
    ``loss`` and ``aux`` come back detached."""
    p = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                 params)
    loss, aux = fn(p, *args)
    flat = [(path, t) for path, t in tree_flatten_with_path(p) if t.requires_grad]
    grads = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
    by_path = {path: (torch.zeros_like(t) if g is None else g)
               for (path, t), g in zip(flat, grads)}
    detach = lambda v: v.detach() if isinstance(v, torch.Tensor) else v
    return ((loss.detach(), tree_map(detach, aux)),
            tree_map_with_path(lambda path, t: by_path.get(path), p))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    grad_accum: int = 1
    compression: Optional[str] = None        # None | "topk" | "int8"
    compression_frac: float = 0.01


def make_train_step(
    loss_fn: Callable,                       # (params, batch) -> (loss, metrics)
    opt_update: Callable,
    step_cfg: StepConfig = StepConfig(),
):
    """Returns ``step(params, opt_state, masks, comp_err, batch, lr)`` ->
    (params', opt_state', comp_err', metrics). ``batch`` is a dict of
    tensors with a leading batch axis. Every step returns new tensors and
    leaves its inputs as they were (the JAX package donates them to its
    jit instead)."""

    def grads_of(params, batch):
        if step_cfg.grad_accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return grads, {**metrics, "loss": loss}

        A = step_cfg.grad_accum
        micro = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])
                 for k, v in batch.items()}
        gsum = tree_map(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                              device=p.device), params)
        loss_sum, per_micro = 0.0, []
        for a in range(A):
            (loss, metrics), g = value_and_grad(
                loss_fn, params, {k: v[a] for k, v in micro.items()})
            gsum = tree_map(lambda s, b: s + b.to(s.dtype), gsum, g)
            loss_sum = loss_sum + loss
            per_micro.append(metrics)
        grads = tree_map(lambda g: g / A, gsum)
        metrics = {k: torch.mean(torch.stack([torch.as_tensor(m[k])
                                              for m in per_micro]))
                   for k in per_micro[0]}
        return grads, {**metrics, "loss": loss_sum / A}

    def step(params, opt_state, masks, comp_err, batch, lr):
        masked = apply_masks(params, masks)
        grads, metrics = grads_of(masked, batch)
        if step_cfg.compression == "topk":
            grads, comp_err = C.topk_compress(grads, comp_err, step_cfg.compression_frac)
        elif step_cfg.compression == "int8":
            grads, comp_err = C.int8_compress(grads, comp_err)
        updates, opt_state = opt_update(grads, opt_state, params, lr)
        params = apply_masks(apply_updates(params, updates), masks)
        gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                               for _, g in tree_flatten_with_path(grads)))
        return params, opt_state, comp_err, {**metrics, "grad_norm": gnorm}

    return step


# ---------------------------------------------------------------------------
# Straggler watchdog (host-side; unit-tested with a fake clock)
# ---------------------------------------------------------------------------

class StepWatchdog:
    """Flags steps slower than ``factor``× the EMA step time. On a real
    cluster the flag feeds the controller's replace-host decision; here it
    is surfaced in metrics/logs."""

    def __init__(self, factor: float = 3.0, ema: float = 0.9,
                 clock: Callable[[], float] = time.monotonic):
        self.factor = factor
        self.ema_w = ema
        self.clock = clock
        self._ema = None
        self._t0 = None
        self.straggler_events = 0

    def start(self):
        self._t0 = self.clock()

    def stop(self) -> bool:
        dt = self.clock() - self._t0
        slow = self._ema is not None and dt > self.factor * self._ema
        if slow:
            self.straggler_events += 1
        # slow steps don't poison the EMA
        if self._ema is None:
            self._ema = dt
        elif not slow:
            self._ema = self.ema_w * self._ema + (1 - self.ema_w) * dt
        return slow


# ---------------------------------------------------------------------------
# Epoch loop with pruning callbacks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EpochCallbacks:
    """``on_epoch_start(epoch, params, masks) -> masks`` lets HAPM / uniform
    pruning update masks between epochs (paper Alg. 3 line 6-10)."""
    on_epoch_start: Optional[Callable] = None
    on_step: Optional[Callable] = None


def run_epochs(
    *, params, opt_state, masks, step_fn, batches_per_epoch, epochs,
    batch_iter, lr_fn, callbacks: EpochCallbacks = EpochCallbacks(),
    comp_err=None, watchdog: Optional[StepWatchdog] = None, log_every: int = 0,
):
    """Simple single-host epoch loop."""
    history = []
    step = 0
    for epoch in range(epochs):
        if callbacks.on_epoch_start is not None:
            masks = callbacks.on_epoch_start(epoch, params, masks)
        losses = []
        for _ in range(batches_per_epoch):
            batch = next(batch_iter)
            lr = lr_fn(step) if callable(lr_fn) else lr_fn
            if watchdog:
                watchdog.start()
            params, opt_state, comp_err, metrics = step_fn(
                params, opt_state, masks, comp_err, batch, lr)
            if watchdog:
                watchdog.stop()
            losses.append(float(metrics["loss"]))
            if callbacks.on_step is not None:
                callbacks.on_step(step, metrics)
            if log_every and step % log_every == 0:
                print(f"  step {step}: loss={losses[-1]:.4f}")
            step += 1
        history.append(float(np.mean(losses)))
    return params, opt_state, masks, comp_err, history
