"""Weight masks -> tile masks -> kernel dispatch plans.

The plan is the kernel-side analogue of the paper's schedule analysis: for each
output tile column ``j`` it lists which K-tiles survive pruning, so the
kernel only visits live tiles (compute *and* loads skipped) — the
Dynamic Sparsity Bypass, hoisted from runtime zero-checks (FPGA) to
dispatch time, which is where a statically-planned kernel wants it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockSparsePlan:
    """Static dispatch plan for one (K, N) weight matrix."""
    block: Tuple[int, int]          # (bk, bn)
    tiles: Tuple[int, int]          # (nKb, nNb)
    idx: np.ndarray                 # (nNb, max_nnz) int32 — K-tile ids per N-tile column
    cnt: np.ndarray                 # (nNb,) int32 — live K-tiles per column
    max_nnz: int

    @property
    def density(self) -> float:
        return float(self.cnt.sum()) / (self.tiles[0] * self.tiles[1])

    @property
    def skipped_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1] - int(self.cnt.sum())


def tile_mask_from_weight(w: np.ndarray, block: Tuple[int, int]) -> np.ndarray:
    """(K, N) weight -> (nKb, nNb) bool; a tile is live iff any element != 0."""
    K, N = w.shape
    bk, bn = block
    nKb, nNb = -(-K // bk), -(-N // bn)
    padded = np.zeros((nKb * bk, nNb * bn), w.dtype)
    padded[:K, :N] = np.asarray(w)
    t = padded.reshape(nKb, bk, nNb, bn)
    return np.abs(t).sum(axis=(1, 3)) > 0


def plan_from_tile_mask(tile_mask: np.ndarray, block: Tuple[int, int]) -> BlockSparsePlan:
    nKb, nNb = tile_mask.shape
    cols = [np.nonzero(tile_mask[:, j])[0].astype(np.int32) for j in range(nNb)]
    max_nnz = max(1, max((len(c) for c in cols), default=1))
    idx = np.zeros((nNb, max_nnz), np.int32)
    cnt = np.zeros((nNb,), np.int32)
    for j, c in enumerate(cols):
        idx[j, :len(c)] = c
        cnt[j] = len(c)
    return BlockSparsePlan(block=tuple(block), tiles=(nKb, nNb), idx=idx, cnt=cnt, max_nnz=max_nnz)


def plan_from_weight(w: np.ndarray, block: Tuple[int, int]) -> BlockSparsePlan:
    return plan_from_tile_mask(tile_mask_from_weight(w, block), block)


def transpose_plan(plan: BlockSparsePlan, tile_mask: np.ndarray) -> BlockSparsePlan:
    """Plan for W^T (used by the dx backward matmul)."""
    return plan_from_tile_mask(tile_mask.T, (plan.block[1], plan.block[0]))
