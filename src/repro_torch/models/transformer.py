"""Decoder-only LM covering the dense / moe / vlm / audio families. One
stacked parameter tree per homogeneous layer stack:

* ``layer_pattern="global"``  — a single stack run L times;
* ``layer_pattern="local_global"`` — gemma-2-style strict alternation, run
  as L/2 (local, global) *pairs* so the two flavors keep separate KV-cache
  lengths (local layers only ever need a ``sliding_window`` ring).

Params are nested dicts of tensors whose stacked leaves carry the layer
as their leading dim, as in the JAX package, so ``dist.param_specs`` maps
one to one and JAX's weights carry across with no reshaping
(``lm.params_from_numpy``). ``forward`` loops over the stack's layers in
Python (``_unstack``), where the JAX package runs ``lax.scan``. ``cfg.remat``
rematerializes each layer (a ``(local, global)`` pair) in training, as the
JAX package's ``_remat`` wraps the scan body (:func:`_remat`); a forward
that records no gradient runs as it is. The serving entry points
(``prefill``, ``decode_step``) are ``models/lm.py``'s, as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import checkpoint as CP

from ..core.masks import tree_leaves, tree_map, tree_map_with_path
from ..dist.api import constrain
from .cnn import resolve_device
from .lm_config import LMConfig
from . import layers as L
from . import moe as MOE

PyTree = Any


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack(trees: list) -> PyTree:
    return tree_map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree_map(lambda t: t[i], stacked)


def _unstack(stacked: PyTree) -> list:
    """The layers of a stacked tree, as views. ``unbind`` has one backward
    for the whole stack (the layers' gradients stacked once); indexing
    layer by layer would give each layer a gradient of the whole stack."""
    is_parts = lambda x: isinstance(x, tuple)
    parts = tree_map(lambda t: t.unbind(0), stacked)
    n = len(tree_leaves(parts, is_leaf=is_parts)[0])
    return [tree_map(lambda ts: ts[i], parts, is_leaf=is_parts) for i in range(n)]


def generator(seed, dev: torch.device):
    """``seed`` (an int or a ``torch.Generator``) as a generator on ``dev``;
    on the meta device nothing is drawn."""
    if isinstance(seed, torch.Generator) or dev.type == "meta":
        return seed
    return torch.Generator(device=dev).manual_seed(int(seed))


def stack_init(layer_init, gen, n: int, *args, **kw):
    return _stack([layer_init(gen, *args, **kw) for _ in range(n)])


# ---------------------------------------------------------------------------
# One block = attn + (ffn | moe), pre-norm (+ gemma2 sandwich post-norms)
# ---------------------------------------------------------------------------

def block_init(gen, cfg: LMConfig, dtype, device=None):
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros(), "attn": L.attn_init(gen, cfg, dtype, device=device),
         "ln2": zeros()}
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(gen, cfg, dtype, device=device)
    else:
        p["ffn"] = L.ffn_init(gen, cfg, dtype, device=device)
    if cfg.final_softcap is not None:  # gemma2 sandwich norms
        p["post_ln1"] = zeros()
        p["post_ln2"] = zeros()
    return p


def block_apply(p, x, cfg: LMConfig, positions, window, cache, prefix_len):
    h = L.rmsnorm(x, p["ln1"])
    a, new_cache = L.attn_apply(p["attn"], h, cfg, positions, window, cache, prefix_len)
    if "post_ln1" in p:
        a = L.rmsnorm(a, p["post_ln1"])
    x = x + a
    h = L.rmsnorm(x, p["ln2"])
    if cfg.family == "moe":
        f, aux = MOE.moe_apply(p["moe"], h, cfg)
    else:
        f = L.ffn_apply(p["ffn"], h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "post_ln2" in p:
        f = L.rmsnorm(f, p["post_ln2"])
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init(seed: Union[int, torch.Generator], cfg: LMConfig, device=None) -> PyTree:
    """Random weights in ``cfg.dtype`` (MoE routers in f32) on ``device``
    (the card unless asked otherwise), drawn on that device from ``seed``
    (an int or a ``torch.Generator``). On the meta device: the tree's
    shapes and dtypes only."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    dt = _dtype(cfg)
    params: dict = {
        "embed": (L.normal(gen, (cfg.vocab_size, cfg.d_model), dev) * 0.02).to(dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if cfg.layer_pattern == "local_global":
        assert cfg.num_layers % 2 == 0
        params["blocks_local"] = stack_init(block_init, gen, cfg.num_layers // 2, cfg, dt,
                                            device=dev)
        params["blocks_global"] = stack_init(block_init, gen, cfg.num_layers // 2, cfg, dt,
                                             device=dev)
    else:
        params["blocks"] = stack_init(block_init, gen, cfg.num_layers, cfg, dt, device=dev)
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device=dev)
    return params


# ---------------------------------------------------------------------------
# Forward (train / prefill / decode) — caches optional
# ---------------------------------------------------------------------------

# the weight products: ``x @ w`` of a (..., K) activation and a (K, N)
# weight folds the leading dims into one ``mm``; attention's products carry
# batch dims (``bmm``) and are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    P = CP.CheckpointPolicy
    return P.MUST_SAVE if op in _SAVED_DOTS else P.PREFER_RECOMPUTE


def _remat(fn, cfg: LMConfig):
    """``fn`` (one layer) under ``cfg.remat`` when autograd records it: the
    backward recomputes the layer from its inputs (``"full"``,
    ``torch.utils.checkpoint``), or keeps the outputs of the weight
    products and recomputes the rest (``"dots"``: what JAX's
    ``dots_with_no_batch_dims_saveable`` keeps); ``"none"`` keeps every
    activation autograd saves."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"use_reentrant": False, "preserve_rng_state": False}   # the layers draw nothing
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: CP.create_selective_checkpoint_contexts(_dots_saveable)
    return lambda *args: CP.checkpoint(fn, *args, **kw)


def embed_inputs(params, batch, cfg: LMConfig):
    """tokens and/or precomputed frontend embeddings -> (x, prefix_len)."""
    dt = _dtype(cfg)
    parts = []
    prefix_len = 0
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(dt))
        prefix_len = batch["embeds"].shape[1]
    if batch.get("tokens") is not None:
        parts.append(params["embed"][batch["tokens"].long()])
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt, device=x.device)
    if cfg.family != "vlm":
        prefix_len = 0  # audio embeds are the whole (causal) sequence
    return x, prefix_len


def unembed(params, x, cfg: LMConfig):
    logits = x @ params["embed"].T if cfg.tie_embeddings else x @ params["head"]
    logits = logits.float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return constrain(logits, "batch", "seq", "vocab")


def _run_stack(stack, caches, x, cfg, positions, windows, prefix_len, auxs):
    """Run the layers of ``stack`` (one stacked tree per flavor, applied in
    turn within a layer index: ``(local, global)`` pairs or one block) on
    ``x``; returns (x, the new caches stacked like ``caches``)."""
    layers = [_unstack(st) for st in stack]
    new = [[] for _ in stack]

    def layer(x, layers, cs):
        out = []
        for p, window, c in zip(layers, windows, cs):
            x, nc, aux = block_apply(p, x, cfg, positions, window, c, prefix_len)
            out.append((nc, aux))
        return x, out

    body = _remat(layer, cfg)
    for i in range(len(layers[0])):
        cs = [None] * len(stack) if caches is None else [_layer(c, i) for c in caches]
        x, out = body(x, [ls[i] for ls in layers], cs)
        for j, (nc, aux) in enumerate(out):
            new[j].append(nc)
            auxs.append(aux)
    if caches is None:
        return x, None
    return x, [_stack(n_j) for n_j in new]


def forward(
    params: PyTree,
    batch: dict,
    cfg: LMConfig,
    caches: Optional[PyTree] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
    """Returns (logits, new_caches, aux). ``caches`` stacked over layers."""
    x, prefix_len = embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x = constrain(x, "batch", "seq", "embed")

    window = cfg.sliding_window
    auxs: list = []
    if cfg.layer_pattern == "local_global":
        cs = None if caches is None else [caches["local"], caches["global"]]
        x, new = _run_stack([params["blocks_local"], params["blocks_global"]], cs, x, cfg,
                            positions, (window, None), prefix_len, auxs)
        new_caches = None if new is None else {"local": new[0], "global": new[1]}
    else:
        cs = None if caches is None else [caches]
        x, new = _run_stack([params["blocks"]], cs, x, cfg, positions, (window,),
                            prefix_len, auxs)
        new_caches = None if new is None else new[0]

    x = L.rmsnorm(x, params["final_norm"])
    return unembed(params, x, cfg), new_caches, _sum_aux(auxs, cfg)


def _sum_aux(auxs: list, cfg: LMConfig) -> torch.Tensor:
    """The sum over layers, as the JAX scan's stacked aux is summed (a pair
    of the local/global stack adds its two first)."""
    if cfg.layer_pattern == "local_global":
        auxs = [auxs[i] + auxs[i + 1] for i in range(0, len(auxs), 2)]
    return torch.sum(torch.stack(auxs))


def init_caches(cfg: LMConfig, batch: int, max_len: int, device=None) -> PyTree:
    """Stacked KV caches on ``device`` (the card unless asked otherwise).
    Local stacks allocate only the sliding window."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    Kv, hd = cfg.num_kv_heads, cfg.head_dim

    def stacked(n, length):
        return {
            "k": torch.zeros((n, batch, length, Kv, hd), dtype=dt, device=dev),
            "v": torch.zeros((n, batch, length, Kv, hd), dtype=dt, device=dev),
            "pos": torch.full((n, batch, length), -1, dtype=torch.int32, device=dev),
        }

    if cfg.layer_pattern == "local_global":
        w = min(cfg.sliding_window or max_len, max_len)
        return {
            "local": stacked(cfg.num_layers // 2, w),
            "global": stacked(cfg.num_layers // 2, max_len),
        }
    length = max_len if cfg.sliding_window is None else min(cfg.sliding_window, max_len)
    return stacked(cfg.num_layers, length)
