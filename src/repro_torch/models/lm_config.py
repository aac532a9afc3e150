"""Unified LM architecture config covering the 10 assigned architectures.

A copy of the JAX package's module of the same name (pure Python), so
the port imports nothing of ``repro``; ``tests/test_torch_imports.py``
holds the two equal statement by statement and
``tests/test_torch_lm_transformer.py`` every default and count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads

    # attention flavor
    ffn_type: str = "swiglu"           # swiglu | geglu | gelu
    qk_norm: bool = False              # qwen3
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    sliding_window: Optional[int] = None    # window for local layers
    layer_pattern: str = "global"      # global | local_global (strict alternation)
    attn_impl: str = "chunked"         # chunked (flash-style online softmax) | dense
    attn_chunk: int = 1024             # KV chunk for the online-softmax scan
    rope_theta: float = 10000.0
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = True

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    hybrid_attn_every: int = 6         # zamba2: shared attn after every N mamba layers

    # xLSTM
    xlstm_slstm_every: int = 8         # sLSTM block every Nth layer (others mLSTM)
    xlstm_proj_factor: float = 2.0     # mLSTM up-projection factor

    # frontends (assignment: stubs providing precomputed embeddings)
    frontend: Optional[str] = None     # siglip_stub | encodec_stub
    num_prefix_tokens: int = 0         # vlm: image patch count; audio: frame count

    # training-time knobs
    remat: str = "full"                # none | full | dots
    dtype: str = "bfloat16"
    grad_accum: int = 1                # microbatches per train step
    block_size: Tuple[int, int] = (128, 128)   # HAPM tile group size (MXU-aligned)
    scan_unroll: object = 1            # lax.scan unroll for layer stacks (int or True)
    attn_scan_unroll: int = 1          # unroll for the chunked-attention KV scan

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return max(1, self.ssm_heads // 8)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND model FLOPs."""
        D, H, Kv, hd, F, V, L = (self.d_model, self.num_heads, self.num_kv_heads,
                                 self.head_dim, self.d_ff, self.vocab_size, self.num_layers)
        attn = D * H * hd + 2 * D * Kv * hd + H * hd * D
        if self.ffn_type in ("swiglu", "geglu"):
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F
        if self.family == "moe":
            ffn = self.num_experts * ffn + D * self.num_experts
        mamba = 0
        if self.family in ("ssm", "hybrid") and self.ssm_state:
            din = self.d_inner
            in_proj = D * (2 * din + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads)
            mamba = in_proj + din * D + self.ssm_conv * (din + 2 * self.ssm_groups * self.ssm_state)
        emb = V * D
        if self.family == "hybrid":
            n_attn = self.num_layers // self.hybrid_attn_every
            return emb + L * (mamba + ffn) + attn + 2 * D * L  # shared attn counted once
        if self.family == "ssm" and self.name.startswith("xlstm"):
            pf = self.xlstm_proj_factor
            per = D * int(pf * D) * 2 + 4 * int(pf * D) * hd  # rough
            return emb + L * per
        return emb + L * (attn + ffn + 2 * D)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        per_expert = 3 * D * F
        total = self.param_count()
        return total - self.num_layers * (self.num_experts - self.num_experts_per_tok) * per_expert
