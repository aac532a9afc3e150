"""Transformer primitives shared by every LM architecture of the zoo.

Functional style: ``*_init(gen, cfg, ...) -> params``,
``*_apply(params, x, ...)``. All matmul weights are 2-D ``(in, out)`` (or
stacked ``(L, in, out)``) so ``core.tpu_tile_groups`` can treat any of
them as HAPM tile groups.

The same operations, in the same order and precision, as the JAX
package's ``models/layers.py``: norms and rotary angles in f32, attention
scores in f32 with f32 running statistics in the chunked online softmax.
Weights are drawn from an explicit ``torch.Generator`` (so their values
are not the JAX package's; parity tests carry JAX's weights across).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.api import constrain
from .lm_config import LMConfig

NEG_INF = -1e30


def normal(gen: Optional[torch.Generator], shape, device=None) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``gen`` (on the generator's
    device), moved to ``device``; on the meta device, shapes only (no
    draw, no memory: spec derivation over a full-size config)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def dense_init(gen: torch.Generator, d_in, d_out, dtype, scale=None, device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (normal(gen, (d_in, d_out), device) * scale).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = True) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (x * scale).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). NeoX-style."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                      # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + all assigned flavors) with optional KV cache
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: LMConfig, dtype, device=None) -> dict:
    D, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, D, H * hd, dtype, device=device),
        "wk": dense_init(gen, D, Kv * hd, dtype, device=device),
        "wv": dense_init(gen, D, Kv * hd, dtype, device=device),
        "wo": dense_init(gen, H * hd, D, dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _gqa_scores(q, k, softcap):
    """q: (B,Sq,H,hd) k: (B,Sk,Kv,hd) -> (B,Kv,Hq,Sq,Sk), f32 (the products
    of the operands' dtype accumulated in f32)."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    q = q.reshape(B, Sq, Kv, H // Kv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    s = s / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def _gqa_out(probs, v):
    """probs: (B,Kv,Hq,Sq,Sk) v: (B,Sk,Kv,hd) -> (B,Sq,H*hd)."""
    B, Kv, Hq, Sq, Sk = probs.shape
    o = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return o.reshape(B, Sq, Kv * Hq * v.shape[-1])


def _attn_mask(q_pos, k_pos, window, prefix_len):
    """(B,1,1,Sq,Sk) bool. -1 cache slots invalid; causal; optional sliding
    window; optional bidirectional prefix (vlm)."""
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    mask = (kp <= qp) & (kp >= 0)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    if prefix_len:
        mask = mask | ((qp < prefix_len) & (kp < prefix_len) & (kp >= 0))
    return mask


def attention_core(
    q: torch.Tensor,              # (B,Sq,H,hd), RoPE applied
    k: torch.Tensor,              # (B,Sk,Kv,hd), RoPE applied
    v: torch.Tensor,              # (B,Sk,Kv,hd)
    q_pos: torch.Tensor,          # (B,Sq) int
    k_pos: torch.Tensor,          # (B,Sk) int; -1 marks invalid cache slots
    window: Optional[int],
    softcap: Optional[float],
    prefix_len: int = 0,
) -> torch.Tensor:
    s = _gqa_scores(q, k, softcap)                   # (B,Kv,Hq,Sq,Sk)
    s = torch.where(_attn_mask(q_pos, k_pos, window, prefix_len), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v)


def attention_core_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: Optional[int],
    softcap: Optional[float],
    prefix_len: int = 0,
    chunk: int = 1024,
    unroll: int = 1,
) -> torch.Tensor:
    """Flash-style online-softmax attention: a loop over KV chunks with
    running (max, denom, acc), in f32. Peak score memory O(Sq·chunk)
    instead of O(Sq·Sk). ``Sk`` not a multiple of ``chunk`` takes one chunk
    of ``Sk``. The chunks run in a Python loop, in order; ``unroll`` (the
    JAX scan's unroll factor) is accepted and has no meaning here."""
    del unroll
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if Sk % chunk:
        chunk = Sk  # fallback (small/odd shapes)
    Hq = H // Kv
    qh = q.reshape(B, Sq, Kv, Hq, hd).permute(0, 2, 3, 1, 4)      # (B,Kv,Hq,Sq,hd)
    qh = qh.float() / math.sqrt(hd)

    m = torch.full((B, Kv, Hq, Sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Kv, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, Hq, Sq, hd), dtype=torch.float32, device=q.device)
    # ``split``: one backward for all chunks, not a slice of the whole K/V each
    for kci, vci, kpi in zip(k.split(chunk, dim=1), v.split(chunk, dim=1),
                             k_pos.split(chunk, dim=1)):
        s = torch.einsum("bkgqh,bskh->bkgqs", qh, kci.float())
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = _attn_mask(q_pos, kpi, window, prefix_len)
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe[..., None])                         # masked -> 0
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe), 0.0)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vci.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H * hd)
    return out.to(q.dtype)


def _ring_write(buf: torch.Tensor, new: torch.Tensor, last: torch.Tensor,
                written: torch.Tensor) -> torch.Tensor:
    """``buf`` (B,W,...) with slot ``w`` of row ``b`` replaced by
    ``new[b, last[b, w]]`` where ``written[b, w]``."""
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    picked = new[rows, last.clamp(min=0)].to(buf.dtype)
    keep = written.reshape(written.shape + (1,) * (buf.dim() - 2))
    return torch.where(keep, picked, buf)


def attn_apply(
    p: dict,
    x: torch.Tensor,              # (B,S,D)
    cfg: LMConfig,
    positions: torch.Tensor,      # (B,S)
    window: Optional[int] = None,
    cache: Optional[dict] = None, # {"k","v": (B,W,Kv,hd), "pos": (B,W)} ring buffer
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, Optional[dict]]:
    B, S, D = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Kv, hd)
    v = (x @ p["wv"]).reshape(B, S, Kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "heads", None)  # heads-sharded inside attn

    def core(qq, kk, vv, kp):
        if cfg.attn_impl == "chunked" and kk.shape[1] > cfg.attn_chunk:
            return attention_core_chunked(qq, kk, vv, positions, kp, window,
                                          cfg.attn_softcap, prefix_len,
                                          chunk=cfg.attn_chunk,
                                          unroll=cfg.attn_scan_unroll)
        return attention_core(qq, kk, vv, positions, kp, window,
                              cfg.attn_softcap, prefix_len)

    if cache is None:
        o = core(q, k, v, positions)
        new_cache = None
    else:
        # ring-buffer write at slot = pos % W (W == allocated cache length).
        # Where two positions of a row share a slot (a prefill longer than
        # the window) the later one wins, as the JAX scatter applies them
        # in order: each slot takes the last position that maps to it.
        W = cache["k"].shape[1]
        slots = (positions % W).long()                            # (B,S)
        order = torch.arange(S, device=x.device).expand(B, S)
        last = torch.full((B, W), -1, dtype=torch.long, device=x.device)
        last = last.scatter_reduce(1, slots, order, reduce="amax")
        written = last >= 0
        ck = _ring_write(cache["k"], k, last, written)
        cv = _ring_write(cache["v"], v, last, written)
        cpos = _ring_write(cache["pos"], positions, last, written)
        o = core(q, ck, cv, cpos)
        new_cache = {"k": ck, "v": cv, "pos": cpos}

    out = o @ p["wo"]
    return constrain(out, "batch", "seq", "embed"), new_cache


def attn_cache_init(cfg: LMConfig, batch: int, length: int, dtype, device=None) -> dict:
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, Kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, Kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# FFN (GLU family)
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, cfg: LMConfig, dtype, d_ff: Optional[int] = None,
             device=None) -> dict:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_type in ("swiglu", "geglu"):
        return {
            "wi": dense_init(gen, D, Fd, dtype, device=device),
            "wg": dense_init(gen, D, Fd, dtype, device=device),
            "wo": dense_init(gen, Fd, D, dtype, device=device),
        }
    return {"wi": dense_init(gen, D, Fd, dtype, device=device),
            "wo": dense_init(gen, Fd, D, dtype, device=device)}


def ffn_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.ffn_type == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    h = constrain(h, "batch", "seq", "ffn")
    return constrain(h @ p["wo"], "batch", "seq", "embed")
