"""CNN training harness for the paper's four model variants (Table I):
(1) fp32, (2) int8 QAT, (3) int8 + uniform pruning [Zhu-Gupta],
(4) int8 + HAPM — optionally with the HAPM epochs run forward and backward
through a trainable bind of the block-sparse kernels (``sparse_training``;
at the default contract only the sparsest convs bind, see
:func:`train_variant`).

The twin of the JAX package's ``benchmarks/cnn_training.py``, kept inside
the port's package (the port has no ``benchmarks/`` tree yet). The same
update rule (SGD-momentum 0.9, weight decay 1e-4, ReduceLROnPlateau on the
epoch loss), the same mask discipline (mask before the loss, re-mask after
the update) and the same per-epoch HAPM rebind. Everything runs on
``device`` — the GPU unless the caller passes ``device="cpu"``.

Epoch counts default far below the paper's 200/100/100/60; relative
orderings are what the synthetic set reproduces at reduced scale.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import (HAPMConfig, UniformPruneConfig, apply_masks, full_masks,
                    hapm_element_masks, hapm_epoch_update, hapm_init,
                    maybe_update)
from ..core.masks import tree_map
from ..data.synthetic import SyntheticCifar
from ..models import cnn
from .loop import value_and_grad
from .optimizer import ReduceLROnPlateau, apply_updates, sgd


@dataclasses.dataclass
class TrainedModel:
    name: str
    cfg: cnn.ResNetConfig
    params: dict
    state: dict
    masks: Optional[dict]
    history: list
    test_accuracy: float


def _loss_fn(params, state, batch, cfg, sparse=None):
    logits, new_state = cnn.apply(params, state, batch["x"], cfg, train=True,
                                  sparse=sparse)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.mean(torch.gather(logp, 1, batch["y"].long()[:, None]))
    return nll, new_state


def _sgd_step(params, state, opt_state, masks, batch, lr, cfg, sparse=None):
    mp = apply_masks(params, masks)
    (loss, new_state), grads = value_and_grad(_loss_fn, mp, state, batch, cfg,
                                              sparse)
    _, opt_update = sgd(momentum=0.9, weight_decay=1e-4)
    updates, opt_state = opt_update(grads, opt_state, params, lr)
    params = apply_masks(apply_updates(params, updates), masks)
    return params, new_state, opt_state, loss


def _train_step(params, state, opt_state, masks, batch, lr, cfg):
    """One dense SGD step (library convolutions)."""
    return _sgd_step(params, state, opt_state, masks, batch, lr, cfg)


def make_sparse_train_step(cfg, sparse):
    """SGD step running forward and backward through a ``trainable=True``
    sparse bind (the block-sparse kernels with their ``autograd.Function``
    backward). The exec is closed over; it changes every HAPM epoch, so
    each rebind gets its own step. Identical update rule to
    :func:`_train_step`; pruned groups receive exactly-zero gradients from
    the kernel backward, and the mask re-application after the update keeps
    the optimizer's momentum from resurrecting them."""
    if not getattr(sparse, "trainable", False):
        raise ValueError(
            "sparse training needs a bind with ExecSpec(trainable=True)")

    def step(params, state, opt_state, masks, batch, lr):
        return _sgd_step(params, state, opt_state, masks, batch, lr, cfg,
                         sparse)

    return step


@torch.no_grad()
def evaluate(params, state, cfg, ds: SyntheticCifar, batch=256,
             device=None) -> float:
    dev = cnn.resolve_device(device)
    correct = 0
    for i in range(0, ds.num_test - batch + 1, batch):
        x = torch.from_numpy(ds.test_x[i:i + batch]).to(dev)
        logits, _ = cnn.apply(params, state, x, cfg, train=False)
        y = torch.from_numpy(ds.test_y[i:i + batch]).to(dev)
        correct += int(torch.sum(torch.argmax(logits, -1) == y))
    n = (ds.num_test // batch) * batch
    return correct / max(n, 1)


def train_variant(
    variant: str,
    ds: SyntheticCifar,
    epochs: int,
    *,
    batch: int = 128,
    base_lr: float = 0.05,
    init_from: Optional[TrainedModel] = None,
    n_cu: int = 12,
    uniform_sparsity: float = 0.8,
    hapm_sparsity: float = 0.5,
    sparse_training: bool = False,
    verbose: bool = True,
    device=None,
) -> TrainedModel:
    """Train one variant of the paper's ``ResNetConfig()`` (QAT for all
    but fp32). With ``sparse_training`` (hapm only) every epoch after the
    first pruning rebinds an ``ExecSpec(n_cu=n_cu, trainable=True)`` exec
    and runs its steps through it. That default contract binds only the
    convs whose tile plan is below ``dense_fallback`` (0.999) dense; the
    others train on the dense library convolution (at sparsity 0.5 on
    ``ResNetConfig()``, 19 of 21)."""
    if variant not in ("fp32", "int8", "uniform", "hapm"):
        raise ValueError(f"unknown variant {variant!r}")
    if sparse_training and variant != "hapm":
        raise ValueError(
            "sparse_training executes the HAPM group plan; other variants "
            "have no group masks to bind")
    dev = cnn.resolve_device(device)
    cfg = cnn.ResNetConfig(quantized=(variant != "fp32"))
    if init_from is not None:
        # a TrainedModel may seed several variants (fp32 -> int8 ->
        # {uniform, hapm}): start from copies
        params = tree_map(lambda t: t.detach().clone().to(dev), init_from.params)
        state = tree_map(lambda t: t.detach().clone().to(dev), init_from.state)
    else:
        params, state = cnn.init(0, cfg, device=dev)

    opt_init, _ = sgd(momentum=0.9, weight_decay=1e-4)
    opt_state = opt_init(params)
    masks = full_masks(params, cnn.is_conv_weight)   # all-ones until a pruner acts
    steps_per_epoch = ds.num_train // batch

    ucfg = UniformPruneConfig(
        target_sparsity=uniform_sparsity, begin_step=0,
        end_step=max(int(0.7 * epochs * steps_per_epoch), 1),
        update_every=max(steps_per_epoch // 2, 1))
    specs = cnn.conv_group_specs(params, n_cu)
    hcfg = HAPMConfig(hapm_sparsity, epochs)
    hstate = hapm_init(specs, hcfg)

    sched = ReduceLROnPlateau(base_lr=base_lr, factor=0.5, patience=2)
    history = []
    step = 0
    for epoch in range(epochs):
        sparse_step = None
        if variant == "hapm":
            hstate = hapm_epoch_update(hstate, specs, params, hcfg)
            masks = tree_map(lambda m: m.to(dev),
                             hapm_element_masks(specs, hstate))
            if sparse_training and hstate.groups_pruned > 0:
                # the pattern just moved: rebind (plans + autograd conv
                # closures) once per epoch. No weights are prepacked by a
                # trainable bind, so the mid-epoch weight updates can never
                # go stale.
                exec_ = cnn.bind_execution(
                    params, cfg,
                    spec=cnn.ExecSpec(n_cu=n_cu, trainable=True),
                    specs=specs, group_masks=hstate.group_masks, device=dev)
                sparse_step = make_sparse_train_step(cfg, exec_)
        losses = []
        t0 = time.time()
        for x, y in ds.epoch(batch, seed=epoch + 1):
            if variant == "uniform":
                masks = maybe_update(step, apply_masks(params, masks), masks, ucfg)
            b = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
            if sparse_step is not None:
                params, state, opt_state, loss = sparse_step(
                    params, state, opt_state, masks, b, sched.lr)
            else:
                params, state, opt_state, loss = _train_step(
                    params, state, opt_state, masks, b, sched.lr, cfg)
            losses.append(float(loss))
            step += 1
        epoch_s = time.time() - t0
        mean_loss = float(np.mean(losses))
        sched.step(mean_loss)
        history.append(mean_loss)
        if verbose:
            path = "sparse-exec" if sparse_step is not None else "dense"
            print(f"  [{variant}] epoch {epoch + 1}/{epochs}: loss={mean_loss:.4f} "
                  f"lr={sched.lr:.4f} [{path} {epoch_s:.1f}s]")

    params = apply_masks(params, masks)
    acc = evaluate(params, state, cfg, ds, device=dev)
    if verbose:
        print(f"  [{variant}] test accuracy: {acc:.4f}")
    return TrainedModel(variant, cfg, params, state, masks, history, acc)


def train_all_variants(ds, epochs=(6, 3, 4, 4), verbose=True, n_cu=12,
                       device=None):
    """Paper Table-I pipeline: fp32 -> int8 (from fp32) -> {uniform, hapm}."""
    kw = dict(verbose=verbose, device=device)
    m1 = train_variant("fp32", ds, epochs[0], **kw)
    m2 = train_variant("int8", ds, epochs[1], init_from=m1, **kw)
    m3 = train_variant("uniform", ds, epochs[2], init_from=m2, **kw)
    m4 = train_variant("hapm", ds, epochs[3], init_from=m2, n_cu=n_cu, **kw)
    return m1, m2, m3, m4
