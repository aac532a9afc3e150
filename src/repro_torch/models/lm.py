"""Unified LM front door: family dispatch, loss, prune-spec derivation,
and the serving entry points (prefill / decode).

Every assigned architecture flows through these functions:

    init(seed, cfg, device)                 -> params
    forward(params, batch, cfg, ...)        -> (logits, caches', aux)
    loss_fn(params, batch, cfg)             -> (loss, metrics)
    init_caches(cfg, batch, max_len, device)-> caches
    prefill / decode_step                   -> (last logits, caches')
    group_specs(params, cfg)                -> HAPM tile GroupSpecs (None elsewhere)

As in the JAX package's ``models/lm.py``; ``device`` defaults to the card
(``resolve_device``), and ``params_from_numpy`` carries the JAX package's
weights across for any family.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.groups import tpu_tile_groups
from ..core.masks import tree_flatten_with_path, tree_map_with_path
from .cnn import resolve_device
from .lm_config import LMConfig
from . import transformer as TF
from . import hybrid as HY

PyTree = Any


def _is_hybrid(cfg: LMConfig) -> bool:
    """zamba2, or a pure Mamba stack (an ``ssm`` family with a state size;
    not in the pool, but supported)."""
    return cfg.family == "hybrid" or (cfg.family == "ssm" and cfg.ssm_state > 0)


def init(seed, cfg: LMConfig, device=None) -> PyTree:
    """Random weights on ``device`` (the card unless asked otherwise) from
    ``seed`` (an int or a ``torch.Generator``); the meta device gives the
    tree's shapes and dtypes only."""
    if _is_hybrid(cfg):
        return HY.hybrid_init(seed, cfg, device=device)
    if cfg.family == "ssm":                           # xLSTM
        return HY.xlstm_init(seed, cfg, device=device)
    return TF.init(seed, cfg, device=device)


def forward(params, batch, cfg: LMConfig, caches=None, positions=None):
    if _is_hybrid(cfg):
        return HY.hybrid_forward(params, batch, cfg, caches, positions)
    if cfg.family == "ssm":
        return HY.xlstm_forward(params, batch, cfg, caches, positions)
    return TF.forward(params, batch, cfg, caches, positions)


def init_caches(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Caches on ``device`` (the card unless asked otherwise; ``"meta"``
    for shapes only)."""
    if _is_hybrid(cfg):
        return HY.hybrid_init_caches(cfg, batch, max_len, device=device)
    if cfg.family == "ssm":
        return HY.xlstm_init_caches(cfg, batch, max_len, device=device)
    return TF.init_caches(cfg, batch, max_len, device=device)


def params_from_numpy(tree_np: PyTree, cfg: LMConfig, device=None) -> PyTree:
    """The JAX package's weights (``np.asarray`` of the leaves of its
    ``lm.init``) as tensors on ``device``, each leaf in the dtype this
    package's ``init`` gives it: ``cfg.dtype`` but the f32 ones (MoE
    routers; Mamba's ``A_log``, ``D`` and ``dt_bias``)."""
    dev = resolve_device(device)
    dtypes = {path: t.dtype for path, t in
              tree_flatten_with_path(init(None, cfg, device="meta"))}

    def f(path, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=dtypes[path])

    return tree_map_with_path(f, tree_np)


def loss_fn(params, batch, cfg: LMConfig, aux_weight: float = 0.01):
    """Next-token cross entropy. ``batch["targets"]`` aligned with logits;
    positions with target < 0 are masked (vlm prefix, padding)."""
    logits, _, aux = forward(params, batch, cfg)
    targets = batch["targets"]
    if logits.shape[1] != targets.shape[1]:   # vlm: logits cover prefix+text
        logits = logits[:, -targets.shape[1]:]
    mask = (targets >= 0).float()
    t = torch.clamp_min(targets, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    metrics = {"nll": loss, "aux": aux, "tokens": torch.sum(mask)}
    return loss + aux_weight * aux, metrics


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------

def _batch_device(batch: dict) -> torch.device:
    return next(v for v in batch.values() if v is not None).device


@torch.no_grad()
def prefill(params, batch, cfg: LMConfig, max_len: Optional[int] = None):
    """Populate caches for ``batch["tokens"]`` ((B,S)); returns
    (last_logits (B,V), caches). The caches live on the batch's device."""
    tokens = batch.get("tokens")
    B = (tokens if tokens is not None else batch["embeds"]).shape[0]
    S = (tokens.shape[1] if tokens is not None else batch["embeds"].shape[1])
    if batch.get("embeds") is not None and tokens is not None:
        S = S + batch["embeds"].shape[1]
    caches = init_caches(cfg, B, max_len or S, device=_batch_device(batch))
    logits, caches, _ = forward(params, batch, cfg, caches=caches)
    return logits[:, -1], caches


@torch.no_grad()
def decode_step(params, caches, token, pos, cfg: LMConfig):
    """One token step. token: (B,) int; pos: (B,) int absolute position.
    Returns (logits (B,V), caches')."""
    batch = {"tokens": token[:, None]}
    logits, caches, _ = forward(params, batch, cfg, caches=caches,
                                positions=pos[:, None])
    return logits[:, -1], caches


# ---------------------------------------------------------------------------
# HAPM integration: tile groups over every hot matmul weight
# ---------------------------------------------------------------------------

_PRUNABLE = {"wq", "wk", "wv", "wo", "wi", "wg", "up", "down", "in_proj",
             "bc_proj", "out_proj", "w"}
_EXCLUDE_PATH = {"embed", "head", "router", "conv_w", "r"}


def prunable(path, leaf) -> bool:
    """``path``: the leaf's dict keys (and sequence indices)."""
    keys = [k for k in path if isinstance(k, str)]
    if any(k in _EXCLUDE_PATH for k in keys):
        return False
    last = path[-1] if path else None
    return last in _PRUNABLE and hasattr(leaf, "ndim") and leaf.ndim >= 2


def group_specs(params: PyTree, cfg: LMConfig) -> PyTree:
    """TPU tile GroupSpecs (cfg.block_size) for every prunable weight."""
    def f(path, leaf):
        if prunable(path, leaf):
            return tpu_tile_groups(tuple(leaf.shape), cfg.block_size)
        return None
    return tree_map_with_path(f, params)


def model_flops_per_token(cfg: LMConfig) -> float:
    """6·N (train) model-FLOPs/token with N = active params (MoE-aware)."""
    return 6.0 * cfg.active_param_count()
