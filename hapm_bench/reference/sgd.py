"""The reference's training steps: masked weights, the QAT forward of
:mod:`.resnet`, the mean cross-entropy, gradients by autograd (over a
pruned conv's live weights: 0 at every pruned entry), and
SGD with momentum and weight decay (``m = momentum * m + g + decay * p``,
``p -= lr * m``), the masks applied again after every update. Float32,
with TF32 off unless ``tf32`` asks for it (the control). Imports only
``torch``."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .resnet import qat_logits


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rebuild(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def train_steps(params: dict, masks: dict, batches, model: dict, opt: dict,
                tf32: bool = False) -> dict:
    """Run ``len(batches)`` steps from ``params`` (raw weights; ``masks``
    {conv path: element mask}). Returns ``{"losses": [...], "p0": {...},
    "g1": {...}, "p_last": {...}}``, flat {leaf path: tensor} dicts: the
    masked start, the first step's gradient, the weights after the last
    step."""
    lr, mom, decay = opt["lr"], opt["momentum"], opt["weight_decay"]
    mask_of = lambda path: masks.get(path)
    p = {path: (v * mask_of(path) if mask_of(path) is not None else v).detach()
         for path, v in _leaves(params)}
    out = {"losses": [], "p0": dict(p)}
    m = {path: torch.zeros_like(v) for path, v in p.items()}
    with matmul_precision(tf32):
        for i, (x, y) in enumerate(batches):
            leaves = {path: v.clone().requires_grad_(True) for path, v in p.items()}
            logits = qat_logits(_rebuild(leaves), x, model)
            loss = F.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                # a pruned conv's weights are its live entries alone: its
                # gradient is 0 at every pruned one
                g = {path: gr * mask_of(path) if mask_of(path) is not None else gr
                     for path, gr in zip(leaves, grads)}
                if i == 0:
                    out["g1"] = g
                for path in p:
                    m[path] = mom * m[path] + (g[path] + decay * p[path])
                    new = p[path] - lr * m[path]
                    p[path] = new * mask_of(path) if mask_of(path) is not None else new
            out["losses"].append(float(loss.detach()))
    out["p_last"] = p
    return out
