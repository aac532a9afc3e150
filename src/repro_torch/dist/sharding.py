"""Rule construction and tree -> PartitionSpec derivation.

``make_rules`` fixes the logical-axis vocabulary for the whole codebase:

  activations : batch, seq, embed, heads, ffn, vocab
  params      : fsdp (the row/"other" dim of every matmul weight)
  decode      : state (feature dims of recurrent state, behind a flag)

Parameter layout (Megatron convention, FSDP on the complementary dim):
column-parallel projections (wq/wk/wv/wi/wg/up) shard their output dim
over ``model`` and their input dim over ``data``; row-parallel
projections (wo/down/out_proj) the transpose. Everything that cannot be
matched — or whose dim does not divide the mesh — replicates, so the same
deriver serves the 16x16 production mesh and 1-device unit tests.

The derivations are pure: they read each leaf's ``shape`` and ``ndim``
only, so a tree of ``torch.empty(..., device="meta")`` leaves of a
full-size config costs no memory. Trees are nested dicts (and lists or
tuples); a leaf's path is its dict keys and sequence indices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..core.masks import tree_map, tree_map_with_path
from .api import NamedSharding, PartitionSpec as P, ShardingRules, divisible_spec
from .api import mesh_axis_names

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShardFlags:
    """Parallelism strategy toggles (the dry-run flag matrix).

    fsdp          — shard the non-TP dim of weights/optimizer state over
                    ``data`` (ZeRO-3 style); off -> weights replicated
                    over ``data``.
    tp            — tensor parallelism over ``model`` (heads/ffn/vocab).
    sp            — sequence parallelism: activations' seq dim over
                    ``model`` in train mode.
    state_shard   — shard decode-state feature dims over ``model``.
    moe_manual_tp — MoE combine-before-reduce manual-TP variant.
    opt_bf16      — bf16 AdamW moments (consumed by the dry-run, not by
                    rule derivation; carried here so one flags object
                    describes a cell).
    """
    fsdp: bool = True
    tp: bool = True
    sp: bool = False
    state_shard: bool = False
    moe_manual_tp: bool = False
    opt_bf16: bool = False


def make_rules(mesh, mode: str = "train",
               flags: Optional[ShardFlags] = None) -> ShardingRules:
    """Logical->mesh rules for one (mesh, mode, flags) cell.

    ``mode`` is ``"train"`` or a serving mode (``"serve"``/``"prefill"``/
    ``"decode"``). Batch axes are every data-ish mesh axis present
    (``pod`` and/or ``data``); TP rides ``model`` when the mesh has one.
    """
    if mode not in ("train", "serve", "prefill", "decode"):
        raise ValueError(f"make_rules: unknown mode {mode!r}")
    flags = flags if flags is not None else ShardFlags()
    names = mesh_axis_names(mesh)
    model = "model" if "model" in names else None
    batch = tuple(a for a in ("pod", "data") if a in names)
    tp = model if flags.tp else None
    rules: Dict[str, Any] = {
        "batch": batch or None,
        "seq": tp if (flags.sp and mode == "train") else None,
        "embed": None,
        "heads": tp,
        "ffn": tp,
        "vocab": tp,
        "fsdp": "data" if (flags.fsdp and "data" in names) else None,
        "state": tp if flags.state_shard else None,
    }
    if flags.moe_manual_tp:
        rules["moe_manual_tp"] = True
    return ShardingRules(mesh=mesh, rules=rules)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# Trailing-dim logical patterns per leaf name; leading (stacked-layer)
# dims replicate. Names cover every family of the LM zoo (transformer,
# moe, mamba, mLSTM, sLSTM).
_PARAM_PATTERNS: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "fsdp"),
    "head": ("fsdp", "vocab"),
    # column-parallel (out dim over model)
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "heads"),
    "wv": ("fsdp", "heads"),
    "wi": ("fsdp", "ffn"),
    "wg": ("fsdp", "ffn"),
    "up": ("fsdp", "heads"),          # mLSTM up-proj widens to heads*hd
    "ffn_up": ("fsdp", "ffn"),
    "w": ("fsdp", "ffn"),             # sLSTM fused i|f|z|o gates
    "w_gates": ("heads", None),       # (di, 2H): 2H rarely divides model
    "in_proj": ("fsdp", "heads"),
    "bc_proj": ("fsdp", "heads"),
    "dt_proj": ("fsdp", "heads"),
    # row-parallel (in dim over model)
    "down": ("heads", "fsdp"),
    "ffn_down": ("ffn", "fsdp"),
    "out_proj": ("heads", "fsdp"),
    # sLSTM recurrence (4, H, hd, hd)
    "r": (None, "heads", None, None),
}

# MoE experts carry a leading (E,) dim inside the pattern itself.
_MOE_PATTERNS: Dict[str, Tuple[Optional[str], ...]] = {
    "wi": (None, "fsdp", "ffn"),
    "wg": (None, "fsdp", "ffn"),
    "wo": (None, "ffn", "fsdp"),
    "router": (None, None),           # crosses the manual region replicated
}

_ATTN_CONTEXT = ("attn", "shared_attn")


def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, P)


def param_specs(params: PyTree, rules: ShardingRules) -> PyTree:
    """Mirror ``params`` with a PartitionSpec per leaf.

    Leaves match by name (last dict key) with attn/moe context
    disambiguating ``wo``; unmatched leaves and indivisible dims
    replicate — never an error (required by elastic restore and smoke
    configs whose dims don't divide the production mesh).
    """
    def assign(path, leaf):
        keys = list(path)
        name = next((k for k in reversed(keys) if isinstance(k, str)), None)
        context = [k for k in keys if isinstance(k, str)][:-1] if name else []
        nd = getattr(leaf, "ndim", 0)
        if "moe" in context and name in _MOE_PATTERNS:
            pat = _MOE_PATTERNS[name]
        elif name == "wo":
            pat = (("heads", "fsdp") if any(c in _ATTN_CONTEXT for c in context)
                   else ("ffn", "fsdp"))
        else:
            pat = _PARAM_PATTERNS.get(name)
        if pat is None or nd < len(pat):
            return P(*([None] * nd))
        logical = (None,) * (nd - len(pat)) + tuple(pat)
        return divisible_spec(rules.spec(*logical), leaf.shape, rules.mesh)

    return tree_map_with_path(assign, params)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(batch: PyTree, rules: ShardingRules) -> PyTree:
    """Leading dim over the batch axes, everything else replicated.

    ``None`` leaves (absent modalities) pass through as ``None``.
    """
    b = rules.rules.get("batch")

    def f(x):
        nd = getattr(x, "ndim", 0)
        if nd == 0:
            return P()
        spec = P(*((b,) + (None,) * (nd - 1)))
        return divisible_spec(spec, x.shape, rules.mesh)

    return tree_map(f, batch)


# Offsets from the END of the shape: caches carry a varying number of
# leading stacked-layer dims, but each leaf kind has a fixed tail layout.
#   k/v  (..., B, W, Kv, hd)   pos  (..., B, W)
#   ssm  (..., B, H, N, P)     conv (..., B, K-1, C)
#   C    (..., B, H, hd, hd)   n (..., B, H, hd)   m (..., B, H)
_CACHE_BATCH_OFFSET = {"k": -4, "v": -4, "pos": -2, "ssm": -4, "conv": -3,
                       "C": -4, "n": -3, "m": -2, "c": -3, "h": -3}
_CACHE_STATE_OFFSET = {"k": -2, "v": -2, "ssm": -3, "conv": -1,
                       "C": -3, "n": -2, "m": -1, "c": -2, "h": -2}


def cache_specs(caches: PyTree, rules: ShardingRules) -> PyTree:
    """Decode-cache specs: batch dim over the batch axes; with the
    ``state_shard`` flag, head-ish feature dims additionally over
    ``model`` (indivisible dims replicate, e.g. Kv heads < model)."""
    b = rules.rules.get("batch")
    state_ax = rules.rules.get("state")

    def f(path, x):
        keys = list(path)
        name = next((k for k in reversed(keys) if isinstance(k, str)), None)
        slstm = "slstm" in keys[:-1]
        nd = getattr(x, "ndim", 0)
        entries: list = [None] * nd
        boff = -3 if slstm else _CACHE_BATCH_OFFSET.get(name)
        if boff is not None and nd >= -boff:
            entries[nd + boff] = b
        if state_ax is not None:
            foff = -2 if slstm else _CACHE_STATE_OFFSET.get(name)
            if foff is not None and nd >= -foff and entries[nd + foff] is None:
                entries[nd + foff] = state_ax
        return divisible_spec(P(*entries), x.shape, rules.mesh)

    return tree_map_with_path(f, caches)


def to_shardings(spec_tree: PyTree, mesh) -> PyTree:
    """Specs -> NamedShardings (None passes through, for None leaves)."""
    return tree_map(lambda s: None if s is None else NamedSharding(mesh, s),
                    spec_tree, is_leaf=_is_spec_leaf)
