"""Uniform magnitude pruning, the paper's baseline (Zhu & Gupta,
arXiv:1710.01878) at its final sparsity: in every conv weight the
``round(sparsity * n)`` entries of least magnitude are pruned, ties taken in
the weight's flat order. Imports only ``torch`` and ``numpy``."""
from __future__ import annotations

import numpy as np
import torch

from .resnet import get, layers


def masks(params: dict, model: dict, pruning: dict) -> dict:
    """{conv path: element mask}; the count rounds the float32 value of
    ``sparsity * n`` half to even."""
    out = {}
    for path, _, _ in layers(model):
        w = get(params, path)
        mags = torch.abs(w.reshape(-1)).cpu().numpy()
        n = mags.size
        k = int(np.round(np.float32(pruning["sparsity"] * n)))
        keep = np.ones(n, np.float32)
        keep[np.argsort(mags, kind="stable")[:k]] = 0.0
        out[path] = torch.from_numpy(keep).reshape(w.shape).to(w.device)
    return out
