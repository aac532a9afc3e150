"""Top-k routed MoE FFN (Mixtral / Granite style) with capacity-based
dispatch.

The same dispatch as the JAX package's ``models/moe.py``: router in f32,
top-k with ties to the lower expert index (as ``lax.top_k``), gates
renormalized over the chosen experts, the Switch load-balance loss, and
token-major ranks within each expert by ``cumsum``; a (token, slot) whose
rank reaches the capacity is dropped (its output row is zero).

Without installed sharding rules the local function runs directly. Under
rules (``dist.use_rules``) the port runs eagerly on local tensors, one
process per rank:

* ``moe_manual_tp`` (and an ``ffn`` mesh axis dividing ``d_ff``): the JAX
  package's manual-TP region. x and the weights cross into f32, each rank
  runs its ``d_ff`` shard, the partial outputs are summed after the token
  combine by ``all_reduce`` over the ``model`` mesh dim's group, and the
  result is cast back. On a ``(1, 1)`` mesh that is a one-rank
  ``all_reduce``; the flag changes the numbers as it does in JAX (f32
  experts).
* otherwise, with more than one batch shard: each rank dispatches its own
  batch rows through the whole (``full_tensor``) weights, and the aux loss
  is the mean over the batch shards. With one batch shard the local
  function runs, as in JAX.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.api import current_rules, mesh_shape
from .lm_config import LMConfig
from .layers import dense_init, normal


def moe_init(gen: torch.Generator, cfg: LMConfig, dtype, device=None) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(D)

    return {
        "router": dense_init(gen, D, E, torch.float32, device=device),
        "wi": (normal(gen, (E, D, Fd), device) * scale).to(dtype),
        "wg": (normal(gen, (E, D, Fd), device) * scale).to(dtype),
        "wo": (normal(gen, (E, Fd, D), device) / math.sqrt(Fd)).to(dtype),
    }


def _capacity(tokens: int, cfg: LMConfig) -> int:
    c = int(np.ceil(cfg.num_experts_per_tok * tokens * cfg.capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # pad to a lane-friendly multiple


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last dim, largest
    first and, among equal values, the lower index first (``lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: LMConfig, capacity: int) -> dict:
    """The dispatch of ``T`` tokens' router ``logits`` (T, E), f32:
    ``gates`` (T, K), ``eidx`` (T, K), ``aux`` (the Switch loss), and per
    (token, slot) in token-major order its ``rank`` within its expert,
    ``keep`` (rank < capacity) and buffer ``slot`` (``E * capacity`` when
    dropped)."""
    T = logits.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    gate_vals, eidx = top_k(logits, K)                             # (T,K)
    gates = torch.softmax(gate_vals, dim=-1)                       # renorm over chosen (Mixtral)

    # load-balance aux (Switch eq. 4): E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(eidx, E).float()                            # (T,K,E)
    f_e = torch.mean(torch.sum(onehot, dim=1), dim=0)
    aux = E * torch.sum(f_e * torch.mean(probs, dim=0))

    # rank of each (token, slot) within its expert, token-major priority
    oh = onehot.reshape(T * K, E)
    ranks = torch.cumsum(oh, dim=0) - oh
    rank = torch.sum(ranks * oh, dim=-1).to(torch.int32)           # (T*K,)
    flat_e = eidx.reshape(T * K)
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, E * capacity)  # OOB -> dropped
    return {"gates": gates, "eidx": eidx, "aux": aux, "rank": rank, "keep": keep,
            "slot": slot}


def _experts(x, p, r, cfg: LMConfig, capacity: int):
    """Scatter the tokens into the (E, capacity) buffer, run the SwiGLU
    experts, gather back: (T*K, D) rows, zero where dropped, ungated."""
    T, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    slot, keep = r["slot"], r["keep"]
    tok_of = torch.arange(T * K, device=x.device) // K
    # one spare row takes every dropped (token, slot) and is cut off
    buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok_of]
    expert_in = buf[:E * capacity].reshape(E, capacity, D)

    h = torch.einsum("ecd,edf->ecf", expert_in, p["wi"])
    g = torch.einsum("ecd,edf->ecf", expert_in, p["wg"])
    h = F.silu(g) * h
    y = torch.einsum("ecf,efd->ecd", h, p["wo"]).reshape(E * capacity, D)

    back = y[torch.clamp(slot, max=E * capacity - 1)]
    return back * keep[:, None].to(y.dtype)


def _moe_local(x: torch.Tensor, p: dict, cfg: LMConfig,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) local tokens; p holds *full* weights.
    Returns (out (T, D), aux load-balance loss scalar)."""
    T, D = x.shape
    K = cfg.num_experts_per_tok
    r = route(x.float() @ p["router"], cfg, capacity)
    back = _experts(x, p, r, cfg, capacity)
    back = back * r["gates"].reshape(T * K, 1).to(back.dtype)
    out = torch.sum(back.reshape(T, K, D), dim=1)
    return out, r["aux"]


def _active_batch_axes(rules, mesh):
    """rules["batch"] -> (ordered tuple, n_shards) of size>1 mesh axes."""
    shape = mesh_shape(mesh)
    batch_axes = rules.rules.get("batch")
    order = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes or ())
    kept = tuple(a for a in order if shape[a] > 1)
    n_shards = int(np.prod([shape[a] for a in kept])) if kept else 1
    return kept, n_shards


def _whole(w: torch.Tensor) -> torch.Tensor:
    return w.full_tensor() if hasattr(w, "full_tensor") else w


def _mean_over(value: torch.Tensor, mesh, axes, n: int) -> torch.Tensor:
    """The mean of a per-rank scalar over the ranks of ``axes``."""
    if n == 1:
        return value
    import torch.distributed as dist
    total = value.clone()
    for a in axes:
        dist.all_reduce(total, group=mesh.get_group(a))
    return total / n


def _moe_apply_manual_tp(p, x, cfg: LMConfig, rules):
    """The manual-TP region: dispatch local, expert FFN on this rank's
    ``d_ff`` shard, one f32 ``all_reduce`` over ``model`` after the combine
    (combine-before-reduce). ``None`` where ``d_ff`` does not divide over
    the ``model`` axis (the caller falls back to the other variant)."""
    B, S, D = x.shape
    mesh = rules.mesh
    model_axis = rules.rules["ffn"]
    kept, n_shards = _active_batch_axes(rules, mesh)
    mp = mesh_shape(mesh)[model_axis]
    if cfg.d_ff % mp:
        return None
    capacity = _capacity(B * S, cfg)

    # f32 boundary; this rank's d_ff shard of the expert weights
    f_loc = cfg.d_ff // mp
    r0 = mesh.get_local_rank(model_axis) * f_loc if mp > 1 else 0
    p32 = {k: _whole(w).float() for k, w in p.items()}
    p32["wi"] = p32["wi"][:, :, r0:r0 + f_loc]
    p32["wg"] = p32["wg"][:, :, r0:r0 + f_loc]
    p32["wo"] = p32["wo"][:, r0:r0 + f_loc, :]
    group = mesh.get_group(model_axis)
    out, aux = _moe_local_manual_tp(x.float().reshape(B * S, D), p32, cfg, capacity, group)
    aux = _mean_over(aux, mesh, kept, n_shards)
    return out.reshape(B, S, D).to(x.dtype), aux


def _moe_local_manual_tp(x, p, cfg: LMConfig, capacity: int, group):
    """The expert FFN on a local d_ff shard, the cross-``model`` sum after
    the token combine: the all-reduce payload is (T, D) instead of the
    (E, C, D) expert buffer. f32 in and out."""
    T, D = x.shape
    K = cfg.num_experts_per_tok
    r = route(x @ p["router"], cfg, capacity)
    back = _experts(x, p, r, cfg, capacity) * r["gates"].reshape(T * K, 1)
    out = torch.sum(back.reshape(T, K, D), dim=1)
    import torch.distributed as dist
    dist.all_reduce(out, group=group)                              # (T,D) f32 AR
    return out, r["aux"]


def moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (B,S,D), aux. Under rules, ``x`` is this rank's batch
    rows (see the module docstring)."""
    B, S, D = x.shape
    rules = current_rules()
    if rules is None:
        out, aux = _moe_local(x.reshape(B * S, D), p, cfg, _capacity(B * S, cfg))
        return out.reshape(B, S, D), aux
    if rules.rules.get("moe_manual_tp") and rules.rules.get("ffn"):
        r = _moe_apply_manual_tp(p, x, cfg, rules)
        if r is not None:
            return r

    mesh = rules.mesh
    kept, n_shards = _active_batch_axes(rules, mesh)
    full = {k: _whole(w) for k, w in p.items()}
    out, aux = _moe_local(x.reshape(B * S, D), full, cfg, _capacity(B * S, cfg))
    return out.reshape(B, S, D), _mean_over(aux, mesh, kept, n_shards)
