"""Architecture registry: the 10 assigned LM configs (+ smoke-size twins)
and the paper's own CNN. ``--arch <id>`` everywhere resolves through here.

Sources per assignment header ([source; tier] comments inline). Exact
dimensions as assigned; ``head_dim`` explicit where the source model's
differs from d_model/H.

A copy of the JAX package's module of the same name (pure Python), so
the port imports nothing of ``repro``; ``tests/test_torch_imports.py``
holds the two equal statement by statement and
``tests/test_torch_lm_transformer.py`` every entry field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..models.lm_config import LMConfig


def _shapes(*names):
    return list(names)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: LMConfig
    smoke: LMConfig
    shapes: List[str]
    shape_overrides: Dict[str, dict]
    skips: Dict[str, str]              # shape -> reason


REGISTRY: Dict[str, ArchEntry] = {}


def _register(entry: ArchEntry):
    REGISTRY[entry.config.name] = entry


_FULL_ATTN_SKIP = ("full-attention KV at 524288 is the defining quadratic-"
                   "family cost; assignment: run long_500k only for "
                   "SSM/hybrid/linear-attention archs (DESIGN.md §5)")

# --- zamba2-7b [hybrid] [arXiv:2411.15242; unverified] ----------------------
_register(ArchEntry(
    config=LMConfig(
        "zamba2-7b", "hybrid", num_layers=81, d_model=3584, num_heads=32,
        num_kv_heads=32, d_ff=14336, vocab_size=32000, ssm_state=64,
        ssm_head_dim=64, hybrid_attn_every=6, grad_accum=16),
    smoke=LMConfig(
        "zamba2-7b", "hybrid", num_layers=7, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16,
        ssm_chunk=8, hybrid_attn_every=3, remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    shape_overrides={"long_500k": {"sliding_window": 4096}},  # shared attn windows in long mode
    skips={},
))

# --- musicgen-medium [audio] [arXiv:2306.05284; hf] --------------------------
_register(ArchEntry(
    config=LMConfig(
        "musicgen-medium", "audio", num_layers=48, d_model=1536, num_heads=24,
        num_kv_heads=24, d_ff=6144, vocab_size=2048, ffn_type="gelu",
        frontend="encodec_stub", grad_accum=8),
    smoke=LMConfig(
        "musicgen-medium", "audio", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, ffn_type="gelu",
        frontend="encodec_stub", remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP},
))

# --- gemma2-9b [dense] [arXiv:2408.00118; hf] --------------------------------
_register(ArchEntry(
    config=LMConfig(
        "gemma2-9b", "dense", num_layers=42, d_model=3584, num_heads=16,
        num_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
        ffn_type="geglu", layer_pattern="local_global", sliding_window=4096,
        attn_softcap=50.0, final_softcap=30.0, embed_scale=True, grad_accum=8),
    smoke=LMConfig(
        "gemma2-9b", "dense", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        ffn_type="geglu", layer_pattern="local_global", sliding_window=8,
        attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
        remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP + " (global layers are full attention)"},
))

# --- gemma-7b [dense] [arXiv:2403.08295; hf] ---------------------------------
_register(ArchEntry(
    config=LMConfig(
        "gemma-7b", "dense", num_layers=28, d_model=3072, num_heads=16,
        num_kv_heads=16, head_dim=256, d_ff=24576, vocab_size=256000,
        ffn_type="geglu", embed_scale=True, grad_accum=8),
    smoke=LMConfig(
        "gemma-7b", "dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=192, vocab_size=256,
        ffn_type="geglu", embed_scale=True, remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP},
))

# --- qwen3-32b [dense] [hf:Qwen/Qwen3-8B; hf] --------------------------------
_register(ArchEntry(
    config=LMConfig(
        "qwen3-32b", "dense", num_layers=64, d_model=5120, num_heads=64,
        num_kv_heads=8, head_dim=128, d_ff=25600, vocab_size=151936,
        qk_norm=True, rope_theta=1e6, grad_accum=8),
    smoke=LMConfig(
        "qwen3-32b", "dense", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=256, qk_norm=True,
        remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP},
))

# --- mistral-nemo-12b [dense] [hf:mistralai/Mistral-Nemo-Base-2407; hf] ------
_register(ArchEntry(
    config=LMConfig(
        "mistral-nemo-12b", "dense", num_layers=40, d_model=5120, num_heads=32,
        num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=131072,
        rope_theta=1e6, grad_accum=8),
    smoke=LMConfig(
        "mistral-nemo-12b", "dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP},
))

# --- paligemma-3b [vlm] [arXiv:2407.07726; hf] -------------------------------
_register(ArchEntry(
    config=LMConfig(
        "paligemma-3b", "vlm", num_layers=18, d_model=2048, num_heads=8,
        num_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=257216,
        ffn_type="geglu", embed_scale=True, frontend="siglip_stub",
        num_prefix_tokens=256, grad_accum=8),
    smoke=LMConfig(
        "paligemma-3b", "vlm", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        ffn_type="geglu", embed_scale=True, frontend="siglip_stub",
        num_prefix_tokens=8, remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP},
))

# --- granite-moe-3b-a800m [moe] [hf:ibm-granite; hf] -------------------------
_register(ArchEntry(
    config=LMConfig(
        "granite-moe-3b-a800m", "moe", num_layers=32, d_model=1536,
        num_heads=24, num_kv_heads=8, d_ff=512, vocab_size=49155,
        num_experts=40, num_experts_per_tok=8, grad_accum=8),
    smoke=LMConfig(
        "granite-moe-3b-a800m", "moe", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=32, vocab_size=256, num_experts=8,
        num_experts_per_tok=2, capacity_factor=2.0, remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP},
))

# --- mixtral-8x22b [moe] [arXiv:2401.04088; hf] ------------------------------
_register(ArchEntry(
    config=LMConfig(
        "mixtral-8x22b", "moe", num_layers=56, d_model=6144, num_heads=48,
        num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32768,
        num_experts=8, num_experts_per_tok=2, grad_accum=16),
    smoke=LMConfig(
        "mixtral-8x22b", "moe", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256, num_experts=4,
        num_experts_per_tok=2, capacity_factor=2.0, remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k"),
    shape_overrides={},
    skips={"long_500k": _FULL_ATTN_SKIP +
           " (SWA applies to the 8x7B lineage; 8x22B treated as full attention)"},
))

# --- xlstm-350m [ssm] [arXiv:2405.04517; unverified] -------------------------
_register(ArchEntry(
    config=LMConfig(
        "xlstm-350m", "ssm", num_layers=24, d_model=1024, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=50304, ssm_state=0,
        xlstm_slstm_every=8, grad_accum=8),
    smoke=LMConfig(
        "xlstm-350m", "ssm", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=256, ssm_state=0,
        xlstm_slstm_every=2, remat="none", dtype="float32"),
    shapes=_shapes("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    shape_overrides={},
    skips={},
))


def get(arch: str) -> ArchEntry:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def config_for(arch: str, shape: Optional[str] = None, smoke: bool = False) -> LMConfig:
    e = get(arch)
    cfg = e.smoke if smoke else e.config
    if shape and shape in e.shape_overrides:
        cfg = dataclasses.replace(cfg, **e.shape_overrides[shape])
    return cfg


def cells(include_skips: bool = False):
    """All assigned (arch, shape) cells; skipped cells flagged with reason."""
    out = []
    for arch, e in REGISTRY.items():
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if s in e.shapes:
                out.append((arch, s, None))
            elif include_skips:
                out.append((arch, s, e.skips.get(s, "not assigned")))
    return out
