"""Mask trees, sparsity bookkeeping, and the nested-dict tree walker.

A *mask tree* mirrors a parameter tree: prunable leaves carry a {0,1}
array of the same shape, non-prunable leaves carry ``None``. All pruning
methods in :mod:`repro_torch.core` produce and consume this
representation.

Trees are plain nested dicts (lists and tuples are walked too). The
walker visits dict keys in **sorted** order and names a leaf's path as
``"['s0b0']['conv1']['w']"`` (:func:`keystr`), so leaf order and the
fingerprints built from path strings are stable across dict insertion
orders.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def _is_none(x) -> bool:
    return x is None


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def keystr(path: Tuple) -> str:
    """Path tuple -> ``"['a']['b'][0]"`` (dict keys by ``repr``, sequence
    positions by index)."""
    return "".join(f"[{k!r}]" for k in path)


def tree_flatten_with_path(tree: PyTree, is_leaf: Optional[Callable] = None
                           ) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` depth-first, dict keys sorted. ``None`` is an
    empty subtree (no leaf) unless ``is_leaf`` claims it."""
    out: List[Tuple[Tuple, Any]] = []

    def walk(node, path):
        if is_leaf is not None and is_leaf(node):
            out.append((path, node))
        elif node is None:
            return
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_leaves(tree: PyTree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       is_leaf: Optional[Callable] = None) -> PyTree:
    """Rebuild ``tree`` with ``fn(path, leaf, *rest_leaves)`` at every leaf;
    ``rest`` trees are indexed along the same path."""

    def walk(node, others, path):
        if is_leaf is not None and is_leaf(node):
            return fn(path, node, *others)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k], [None if o is None else o[k] for o in others],
                            path + (k,))
                    for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, [None if o is None else o[i] for o in others],
                                   path + (i,))
                              for i, v in enumerate(node))
        return fn(path, node, *others)

    return walk(tree, list(rest), ())


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    return tree_map_with_path(lambda _p, *leaves: fn(*leaves), tree, *rest,
                              is_leaf=is_leaf)


def apply_masks(params: PyTree, masks: PyTree) -> PyTree:
    """Zero out pruned weights. None-mask leaves pass through untouched."""
    def f(p, m):
        if m is None:
            return p
        m = torch.as_tensor(m, device=p.device)
        return p * m.to(p.dtype)
    return tree_map(f, params, masks)


def full_masks(params: PyTree, prunable: Callable[[tuple, Any], bool]) -> PyTree:
    """Build an all-ones mask tree. ``prunable(path, leaf) -> bool`` selects
    leaves; ``path`` is the tuple of dict keys."""
    def f(path, leaf):
        if prunable(path, leaf):
            return torch.ones(tuple(leaf.shape), dtype=torch.float32,
                              device=leaf.device)
        return None
    return tree_map_with_path(f, params)


def sparsity(mask) -> float:
    """Fraction of zeros in one mask."""
    if mask is None:
        return 0.0
    return float(1.0 - torch.as_tensor(mask, dtype=torch.float32).mean())


def global_sparsity(masks: PyTree) -> float:
    """Weight-count-weighted sparsity over all masked leaves."""
    leaves = tree_leaves(masks)
    if not leaves:
        return 0.0
    total = sum(int(np.prod(l.shape)) for l in leaves)
    zeros = sum(float(torch.sum(1.0 - torch.as_tensor(l, dtype=torch.float32)))
                for l in leaves)
    return zeros / max(total, 1)


def per_leaf_sparsity(masks: PyTree) -> dict:
    """path-string -> sparsity, for Fig.-4-style reporting."""
    return {keystr(path): sparsity(m)
            for path, m in tree_flatten_with_path(masks)}


def count_params(masks: PyTree) -> int:
    return sum(int(np.prod(l.shape)) for l in tree_leaves(masks))
