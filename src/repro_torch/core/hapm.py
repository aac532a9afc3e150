"""HAPM — Hardware Aware Pruning Method (paper Algorithm 3).

Groups are formed from the hardware schedule (:mod:`repro_torch.core.groups`).
At the start of every epoch, the *unpruned* groups of the whole network are
pooled, sorted ascending by sum of absolute weight values, and the ``g``
lowest are pruned; training then continues. ``g`` is fixed at init as
``target_group_sparsity * total_groups / epochs`` (Alg. 3 line 5), so after
``epochs`` epochs the requested fraction of groups is pruned.

The global (cross-layer) pool is what produces the paper's Fig. 4 layout:
some layers end up almost entirely suppressed while others stay intact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .groups import GroupSpec
from .masks import tree_flatten_with_path, tree_leaves, tree_map

PyTree = Any


def _spec_or_none(x) -> bool:
    return x is None or isinstance(x, GroupSpec)


def _is_none(x) -> bool:
    return x is None


@dataclasses.dataclass(frozen=True)
class HAPMConfig:
    target_group_sparsity: float = 0.5   # paper model 4 uses 50 %
    epochs: int = 60
    score: str = "sum_abs"               # paper's scoring; "mean_abs" = size-normalized extension


@dataclasses.dataclass
class HAPMState:
    """``group_masks`` mirrors the param tree: (num_groups,) {0,1} per prunable
    leaf, ``None`` elsewhere. Plain numpy on host — updates happen at epoch
    boundaries."""

    group_masks: PyTree
    g_per_epoch: int
    total_groups: int
    epoch: int = 0

    @property
    def groups_pruned(self) -> int:
        return sum(int(np.sum(m == 0))
                   for m in tree_leaves(self.group_masks, is_leaf=_is_none)
                   if m is not None)


def hapm_init(group_specs: PyTree, config: HAPMConfig) -> HAPMState:
    """``group_specs``: GroupSpec per prunable leaf, None elsewhere."""
    masks = tree_map(
        lambda s: None if s is None else np.ones(s.num_groups, np.float32),
        group_specs, is_leaf=_spec_or_none)
    total = sum(s.num_groups for s in tree_leaves(group_specs, _spec_or_none)
                if isinstance(s, GroupSpec))
    g = int(np.ceil(config.target_group_sparsity * total / max(config.epochs, 1)))
    return HAPMState(group_masks=masks, g_per_epoch=g, total_groups=total)


def hapm_scores(group_specs: PyTree, params: PyTree) -> PyTree:
    """Per-leaf (num_groups,) scores (small tensors on the params' device)."""
    def f(spec, p):
        if not isinstance(spec, GroupSpec):
            return None
        return spec.group_scores(p)
    return tree_map(f, group_specs, params, is_leaf=_spec_or_none)


def hapm_epoch_update(
    state: HAPMState,
    group_specs: PyTree,
    params: PyTree,
    config: HAPMConfig,
    num_groups: Optional[int] = None,
) -> HAPMState:
    """Alg. 3 lines 7–9: sort unpruned groups globally, prune the ``g`` lowest."""
    g = state.g_per_epoch if num_groups is None else num_groups
    target_total = int(round(config.target_group_sparsity * state.total_groups))
    g = min(g, target_total - state.groups_pruned)
    if g <= 0:
        return dataclasses.replace(state, epoch=state.epoch + 1)

    scores_tree = hapm_scores(group_specs, params)
    specs_flat = tree_flatten_with_path(group_specs, _spec_or_none)
    scores_flat = tree_leaves(scores_tree, _is_none)
    masks_flat = tree_leaves(state.group_masks, _is_none)

    pooled, owner, offset = [], [], []
    for li, ((_, spec), sc, m) in enumerate(zip(specs_flat, scores_flat,
                                                masks_flat)):
        if not isinstance(spec, GroupSpec):
            continue
        sc = sc.detach().cpu().numpy().astype(np.float64)
        if config.score == "mean_abs":
            sc = sc / np.maximum(spec.group_elem_counts(), 1)
        if not np.isfinite(sc).all():
            # NaN sorts *after* np.inf, so a diverged layer's groups would
            # silently become unprunable — fail loudly instead
            bad = int(np.count_nonzero(~np.isfinite(sc)))
            raise ValueError(
                f"hapm_epoch_update: layer {li} has {bad} non-finite group "
                f"score(s) — the model diverged; scores must be finite for "
                f"global ranking")
        sc = np.where(np.asarray(m) > 0, sc, np.inf)  # already-pruned: never re-selected
        pooled.append(sc)
        owner.append(np.full(sc.shape, li, np.int32))
        offset.append(np.arange(sc.shape[0], dtype=np.int64))
    pooled = np.concatenate(pooled)
    owner = np.concatenate(owner)
    offset = np.concatenate(offset)

    order = np.argsort(pooled, kind="stable")[:g]
    new_masks_flat = [None if m is None else m.copy() for m in masks_flat]
    for idx in order:
        if not np.isfinite(pooled[idx]):
            break
        new_masks_flat[owner[idx]][offset[idx]] = 0.0

    it = iter(new_masks_flat)
    new_masks = tree_map(lambda _m: next(it), _sorted_view(state.group_masks),
                         is_leaf=_is_none)
    return dataclasses.replace(state, group_masks=new_masks, epoch=state.epoch + 1)


def _sorted_view(tree):
    """The same nested dict with keys in sorted order, so a rebuild that
    consumes a flat leaf list visits leaves in the flatten order."""
    if isinstance(tree, dict):
        return {k: _sorted_view(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_view(v) for v in tree)
    return tree


def hapm_element_masks(group_specs: PyTree, state: HAPMState) -> PyTree:
    """Expand group masks to element masks (consumed by ``masks.apply_masks``)."""
    def f(spec, gm):
        if not isinstance(spec, GroupSpec):
            return None
        return spec.expand(torch.as_tensor(np.asarray(gm)))
    return tree_map(f, group_specs, state.group_masks, is_leaf=_spec_or_none)


def hapm_group_sparsity(state: HAPMState) -> float:
    return state.groups_pruned / max(state.total_groups, 1)
