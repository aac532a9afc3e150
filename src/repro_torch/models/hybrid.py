"""Zamba-2-style hybrid: Mamba-2 backbone with one *shared* attention+FFN
block applied after every ``hybrid_attn_every`` Mamba layers (one weight
set, reused — Zamba's parameter-sharing trick), plus the xLSTM stack
assembly (groups of mLSTM blocks with a sLSTM block every
``xlstm_slstm_every`` layers).

Both are organized as in the JAX package: a loop over super-blocks, and
inside it the homogeneous stack, whose stacked leaves carry the layer as
their leading dim (``params["mamba"]`` is ``(n_super, every, ...)``), so
``dist.param_specs`` maps one to one. Where JAX runs ``lax.scan`` over the
stack, the port loops over its layers in Python (``_unstack``); caches stay
stacked per application. ``cfg.remat`` rematerializes each Mamba and mLSTM layer
in training, as the JAX package wraps those scan bodies (the shared
attention block and the sLSTM block run outside it there too);
``cfg.scan_unroll`` (the scan's unroll in the JAX package) has no effect.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..dist.api import constrain
from .cnn import resolve_device
from .lm_config import LMConfig
from . import layers as L
from . import ssm as SSM
from . import xlstm as XL
from .transformer import (_dtype, _layer, _remat, _stack, _unstack, block_apply,
                          block_init, generator, stack_init, unembed)

PyTree = Any


def _embed(params, batch, cfg: LMConfig):
    x = params["embed"][batch["tokens"].long()]
    return constrain(x, "batch", "seq", "embed")


def _run_stack(apply, stack: PyTree, states: Optional[PyTree], x, cfg: LMConfig):
    """Apply each layer of ``stack`` in turn (a residual block each), with
    its slice of ``states`` when given; returns (x, the new states stacked
    like ``states``, or None)."""
    new = []

    def layer(x, p, st):
        out, nst = apply(p, x, cfg, st)
        return x + out, nst

    body = _remat(layer, cfg)
    for i, layer_params in enumerate(_unstack(stack)):
        x, nst = body(x, layer_params, None if states is None else _layer(states, i))
        new.append(nst)
    return x, (None if states is None else _stack(new))


# ---------------------------------------------------------------------------
# zamba2: hybrid mamba + shared attention
# ---------------------------------------------------------------------------

def hybrid_layout(cfg: LMConfig) -> Tuple[int, int, int]:
    """(n_super, mamba_per_super, n_tail). Shared attn applied n_super times."""
    every = cfg.hybrid_attn_every
    n_super = cfg.num_layers // every
    n_tail = cfg.num_layers - n_super * every
    return n_super, every, n_tail


def hybrid_init(seed, cfg: LMConfig, device=None) -> PyTree:
    """Random weights on ``device`` (the card unless asked otherwise), from
    ``seed`` (an int or a ``torch.Generator``); on the meta device, shapes
    and dtypes only."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    dt = _dtype(cfg)
    n_super, every, n_tail = hybrid_layout(cfg)
    params = {
        "embed": (L.normal(gen, (cfg.vocab_size, cfg.d_model), dev) * 0.02).to(dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        # (n_super, every, ...) stacked mamba layers
        "mamba": _stack([stack_init(SSM.mamba_init, gen, every, cfg, dt, device=dev)
                         for _ in range(n_super)]),
        "shared_attn": block_init(gen, cfg, dt, device=dev),   # ONE weight set (shared)
    }
    if n_tail:
        params["mamba_tail"] = stack_init(SSM.mamba_init, gen, n_tail, cfg, dt, device=dev)
    return params


def hybrid_forward(
    params: PyTree,
    batch: dict,
    cfg: LMConfig,
    caches: Optional[PyTree] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
    n_super, every, n_tail = hybrid_layout(cfg)
    x = _embed(params, batch, cfg)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    decode = caches is not None
    new_caches: Optional[dict] = {"mamba": [], "attn": [], "mamba_tail": None} if decode else None

    for si, mamba in enumerate(_unstack(params["mamba"])):
        st = _layer(caches["mamba"], si) if decode else None
        x, nst = _run_stack(SSM.mamba_apply, mamba, st, x, cfg)
        ac = _layer(caches["attn"], si) if decode else None
        x, nac, _ = block_apply(params["shared_attn"], x, cfg, positions,
                                cfg.sliding_window, ac, 0)
        if decode:
            new_caches["mamba"].append(nst)
            new_caches["attn"].append(nac)

    if n_tail:
        st = caches["mamba_tail"] if decode else None
        x, nst = _run_stack(SSM.mamba_apply, params["mamba_tail"], st, x, cfg)
        if decode:
            new_caches["mamba_tail"] = nst

    if decode:
        new_caches["mamba"] = _stack(new_caches["mamba"])
        new_caches["attn"] = _stack(new_caches["attn"])

    x = L.rmsnorm(x, params["final_norm"])
    return (unembed(params, x, cfg), new_caches,
            torch.zeros((), dtype=torch.float32, device=x.device))


def hybrid_init_caches(cfg: LMConfig, batch: int, max_len: int, device=None) -> PyTree:
    """Stacked Mamba states and shared-attention KV caches on ``device``
    (the card unless asked otherwise); ``"mamba_tail"`` is None where the
    layout has no tail."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n_super, every, n_tail = hybrid_layout(cfg)
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    attn_len = max_len if cfg.sliding_window is None else min(cfg.sliding_window, max_len)

    def mamba_stack(*lead):
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {
            "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_dim), dtype=dt,
                                device=dev),
        }

    return {
        "mamba": mamba_stack(n_super, every),
        "attn": {
            "k": torch.zeros((n_super, batch, attn_len, Kv, hd), dtype=dt, device=dev),
            "v": torch.zeros((n_super, batch, attn_len, Kv, hd), dtype=dt, device=dev),
            "pos": torch.full((n_super, batch, attn_len), -1, dtype=torch.int32, device=dev),
        },
        "mamba_tail": mamba_stack(n_tail) if n_tail else None,
    }


# ---------------------------------------------------------------------------
# xLSTM stack
# ---------------------------------------------------------------------------

def xlstm_layout(cfg: LMConfig) -> Tuple[int, int]:
    """(n_groups, mlstm_per_group): groups of (every-1) mLSTM + 1 sLSTM."""
    every = cfg.xlstm_slstm_every
    if cfg.num_layers % every:
        raise ValueError("xlstm: num_layers % slstm_every != 0")
    return cfg.num_layers // every, every - 1


def xlstm_init(seed, cfg: LMConfig, device=None) -> PyTree:
    """As ``hybrid_init``, for the xLSTM stack."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    dt = _dtype(cfg)
    n_groups, m_per = xlstm_layout(cfg)
    return {
        "embed": (L.normal(gen, (cfg.vocab_size, cfg.d_model), dev) * 0.02).to(dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "mlstm": _stack([stack_init(XL.mlstm_block_init, gen, m_per, cfg, dt, device=dev)
                         for _ in range(n_groups)]),
        "slstm": stack_init(XL.slstm_block_init, gen, n_groups, cfg, dt, device=dev),
    }


def xlstm_forward(
    params: PyTree,
    batch: dict,
    cfg: LMConfig,
    caches: Optional[PyTree] = None,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[PyTree], torch.Tensor]:
    n_groups, m_per = xlstm_layout(cfg)
    x = _embed(params, batch, cfg)
    decode = caches is not None
    new_caches = {"mlstm": [], "slstm": []} if decode else None

    for gi, (mlstm, slstm) in enumerate(zip(_unstack(params["mlstm"]),
                                            _unstack(params["slstm"]))):
        st = _layer(caches["mlstm"], gi) if decode else None
        x, nst = _run_stack(XL.mlstm_block_apply, mlstm, st, x, cfg)
        sc = _layer(caches["slstm"], gi) if decode else None
        out, nsc = XL.slstm_block_apply(slstm, x, cfg, state=sc)
        x = x + out
        if decode:
            new_caches["mlstm"].append(nst)
            new_caches["slstm"].append(nsc)

    if decode:
        new_caches = {"mlstm": _stack(new_caches["mlstm"]),
                      "slstm": _stack(new_caches["slstm"])}

    x = L.rmsnorm(x, params["final_norm"])
    return (unembed(params, x, cfg), new_caches,
            torch.zeros((), dtype=torch.float32, device=x.device))


def xlstm_init_caches(cfg: LMConfig, batch: int, max_len: int, device=None) -> PyTree:
    """Stacked mLSTM and sLSTM states on ``device`` (the card unless asked
    otherwise); their size does not grow with ``max_len``."""
    dev = resolve_device(device)
    n_groups, m_per = xlstm_layout(cfg)
    dt = _dtype(cfg)
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    hd_m = di // H
    hd_s = cfg.d_model // H
    f32 = torch.float32
    return {
        "mlstm": {
            "C": torch.zeros((n_groups, m_per, batch, H, hd_m, hd_m), dtype=f32, device=dev),
            "n": torch.zeros((n_groups, m_per, batch, H, hd_m), dtype=f32, device=dev),
            "m": torch.zeros((n_groups, m_per, batch, H), dtype=f32, device=dev),
            "conv": torch.zeros((n_groups, m_per, batch, 3, di), dtype=dt, device=dev),
        },
        "slstm": {k: torch.zeros((n_groups, batch, H, hd_s), dtype=f32, device=dev)
                  for k in ("c", "n", "h", "m")},
    }
