"""Assigned input-shape sets and meta-device stand-ins (no allocation).

LM shapes (assignment):
  train_4k    : seq 4096,  global_batch 256  -> train_step
  prefill_32k : seq 32768, global_batch 32   -> serve_prefill
  decode_32k  : KV 32768,  global_batch 128  -> serve_step (1 new token)
  long_500k   : KV 524288, global_batch 1    -> serve_step; sub-quadratic archs only

The JAX package's ``ShapeDtypeStruct`` stand-ins are tensors on the
``meta`` device here: a shape and a dtype, no memory.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.lm_config import LMConfig
from ..models import lm


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every model input of the entry point.

    train  : {"batch": {tokens/targets/(embeds)}}
    prefill: {"batch": {tokens/(embeds)}}
    decode : {"token", "pos", "caches"}
    """
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    i32, dt = torch.int32, getattr(torch, cfg.dtype)

    if sp.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"tokens": None,
                     "embeds": _meta((B, S, cfg.d_model), dt),
                     "targets": _meta((B, S), i32)}
        elif cfg.family == "vlm":
            P = cfg.num_prefix_tokens
            batch = {"tokens": _meta((B, S - P), i32),
                     "embeds": _meta((B, P, cfg.d_model), dt),
                     "targets": _meta((B, S - P), i32)}
        else:
            batch = {"tokens": _meta((B, S), i32),
                     "targets": _meta((B, S), i32)}
        if sp.kind == "prefill":
            batch = {k: v for k, v in batch.items() if k != "targets"}
        return {"batch": batch}

    # decode: one new token against a populated cache of S positions
    return {
        "token": _meta((B,), i32),
        "pos": _meta((B,), i32),
        "caches": lm.init_caches(cfg, B, S, device="meta"),
    }
