"""HAPM's group selection (the paper's Algorithm 3, one epoch): every conv
weight is cut into the accelerator's schedule groups, all kx x ky taps of
``n_cu`` consecutive output filters for one input channel; the groups of
the whole network are pooled, ranked by the sum of their absolute weights,
and the lowest ``min(ceil(sparsity * total), round(sparsity * total))``
are pruned: the whole sparsity in the one epoch. Imports only ``torch``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .resnet import get, layers


def group_scores(w: torch.Tensor, n_cu: int) -> torch.Tensor:
    """Sum of |w| per group, groups ordered input channel first, then
    filter block; a last block narrower than ``n_cu`` sums its own filters.
    The float32 sum runs over the same (taps, filters) slab the accelerator
    schedules, so a ranking read from it is the one its definition gives."""
    kx, ky, cin, cout = w.shape
    n_fb = -(-cout // n_cu)
    slabs = F.pad(w, (0, n_fb * n_cu - cout)).reshape(kx * ky, cin, n_fb, n_cu)
    slabs = slabs.permute(1, 2, 0, 3).reshape(cin, n_fb, kx * ky * n_cu)
    return torch.sum(torch.abs(slabs), dim=-1).reshape(-1)


def expand(keep: torch.Tensor, shape, n_cu: int) -> torch.Tensor:
    """(groups,) keep flags -> the element mask of a (kx, ky, cin, cout) weight."""
    kx, ky, cin, cout = shape
    n_fb = -(-cout // n_cu)
    m = keep.reshape(cin, n_fb)[None, None, :, :, None].expand(kx, ky, cin, n_fb, n_cu)
    return m.reshape(kx, ky, cin, n_fb * n_cu)[..., :cout].to(torch.float32)


def masks(params: dict, model: dict, pruning: dict) -> dict:
    """{conv path: element mask} after one epoch of HAPM on ``params``."""
    n_cu, sparsity = pruning["n_cu"], pruning["group_sparsity"]
    paths = sorted(path for path, _, _ in layers(model))    # the pooling order
    scores = [group_scores(get(params, p), n_cu).double().cpu() for p in paths]
    total = sum(int(s.numel()) for s in scores)
    n_prune = min(math.ceil(sparsity * total), int(round(sparsity * total)))
    pooled = torch.cat(scores)
    order = torch.sort(pooled, stable=True).indices[:n_prune]
    keep = torch.ones(total)
    keep[order] = 0.0
    out, off = {}, 0
    for p, s in zip(paths, scores):
        w = get(params, p)
        out[p] = expand(keep[off:off + s.numel()], tuple(w.shape), n_cu).to(w.device)
        off += s.numel()
    return out
