"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM (matrix memory,
parallelizable) and sLSTM (scalar memory, a true recurrence: a Python loop
over the sequence where the JAX package runs ``lax.scan``).

``mlstm_parallel`` (training/prefill) and the stepwise recurrence
(``mlstm_step``) are exact rearrangements of each other — asserted in tests.
xlstm-350m uses groups of (slstm_every-1) mLSTM blocks followed by one sLSTM
block (the paper's xLSTM[7:1] layout for slstm_every=8).

The same operations, in the same order and precision, as the JAX
package's ``models/xlstm.py``: gates, stabilizers and states in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist.api import constrain
from .lm_config import LMConfig
from .layers import dense_init, normal, rmsnorm
from .ssm import _causal_conv

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_parallel(q, k, v, i_raw, f_raw):
    """q,k,v: (B,S,H,hd); i_raw,f_raw: (B,S,H). Returns (B,S,H,hd).

    D_ij = sum_{t=j+1..i} logsig(f_t) + i_j ;  S_ij = (q_i k_j/sqrt(d)) e^{D_ij - m_i}
    h_i = sum_j S_ij v_j / max(|sum_j S_ij|, e^{-m_i})
    """
    B, S, H, hd = q.shape
    lf = F.logsigmoid(f_raw.float())                              # (B,S,H)
    Fc = torch.cumsum(lf, dim=1)
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + i_raw.float()[:, None, :, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))[None, :, :, None]
    D = D.masked_fill(~mask, NEG_INF)                             # (B,Sq,Sk,H)
    m = torch.amax(D, dim=2, keepdim=True)                        # (B,Sq,1,H)
    Dstab = torch.exp(D - m)
    scores = torch.einsum("bihd,bjhd->bijh", q.float(), k.float()) / math.sqrt(hd)
    Sm = scores * Dstab
    norm = torch.maximum(torch.abs(torch.sum(Sm, dim=2)), torch.exp(-m[:, :, 0, :]))
    h = torch.einsum("bijh,bjhd->bihd", Sm, v.float()) / norm[..., None]
    return h.to(q.dtype)


def mlstm_step(state, q, k, v, i_raw, f_raw):
    """One decode step. state: {"C": (B,H,hd,hd), "n": (B,H,hd), "m": (B,H)}.
    q,k,v: (B,H,hd); gates (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    hd = q.shape[-1]
    lf = F.logsigmoid(f_raw.float())
    i_raw = i_raw.float()
    m_new = torch.maximum(lf + m, i_raw)
    fs = torch.exp(lf + m - m_new)[..., None]
    is_ = torch.exp(i_raw - m_new)[..., None]
    kq = k.float() / math.sqrt(hd)
    C = fs[..., None] * C + is_[..., None] * torch.einsum("bhk,bhv->bhkv", kq, v.float())
    n = fs * n + is_ * kq
    qf = q.float()
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.maximum(torch.abs(torch.sum(n * qf, dim=-1)), torch.exp(-m_new))
    h = num / den[..., None]
    return {"C": C, "n": n, "m": m_new}, h.to(q.dtype)


def mlstm_block_init(gen: torch.Generator, cfg: LMConfig, dtype, device=None) -> dict:
    D = cfg.d_model
    di = int(cfg.xlstm_proj_factor * D)
    H = cfg.num_heads
    return {
        "norm": torch.zeros((D,), dtype=dtype, device=device),
        "up": dense_init(gen, D, 2 * di, dtype, device=device),
        "conv_w": (normal(gen, (4, di), device) * 0.1).to(dtype),
        "wq": dense_init(gen, di, di, dtype, device=device),
        "wk": dense_init(gen, di, di, dtype, device=device),
        "wv": dense_init(gen, di, di, dtype, device=device),
        "w_gates": dense_init(gen, di, 2 * H, dtype, device=device),
        "skip": torch.ones((di,), dtype=dtype, device=device),
        "out_norm": torch.zeros((di,), dtype=dtype, device=device),
        "down": dense_init(gen, di, D, dtype, device=device),
    }


def mlstm_block_apply(p, x, cfg: LMConfig, state=None):
    """x: (B,S,D). state (decode): {"C","n","m","conv"}. Three branches: no
    state (training), one step (decode), and a prefill that also returns
    the closed-form final state."""
    B, S, D = x.shape
    di = int(cfg.xlstm_proj_factor * D)
    H = cfg.num_heads
    hd = di // H
    h = rmsnorm(x, p["norm"])
    u, gate = torch.chunk(h @ p["up"], 2, dim=-1)
    cu, new_conv = _causal_conv(u, p["conv_w"], None if state is None else state["conv"])
    cu = F.silu(cu)
    q = (cu @ p["wq"]).reshape(B, S, H, hd)
    k = (cu @ p["wk"]).reshape(B, S, H, hd)
    v = (u @ p["wv"]).reshape(B, S, H, hd)
    gates = cu @ p["w_gates"]
    i_raw, f_raw = torch.chunk(gates.reshape(B, S, 2 * H), 2, dim=-1)
    if state is None:
        o = mlstm_parallel(q, k, v, i_raw, f_raw)
        new_state = None
    elif S == 1:
        st = {"C": state["C"], "n": state["n"], "m": state["m"]}
        st, o = mlstm_step(st, q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
        o = o[:, None]
        new_state = {**st, "conv": new_conv}
    else:
        # prefill: parallel outputs + closed-form final state
        o = mlstm_parallel(q, k, v, i_raw, f_raw)
        lf = F.logsigmoid(f_raw.float())
        Fc = torch.cumsum(lf, dim=1)                                 # (B,S,H)
        d = Fc[:, -1:, :] - Fc + i_raw.float()                       # (B,S,H)
        m_fin = torch.amax(d, dim=1)                                 # (B,H)
        w = torch.exp(d - m_fin[:, None, :])                         # (B,S,H)
        kq = k.float() / math.sqrt(hd)
        C = torch.einsum("bsh,bshk,bshv->bhkv", w, kq, v.float())
        n = torch.einsum("bsh,bshk->bhk", w, kq)
        new_state = {"C": C, "n": n, "m": m_fin, "conv": new_conv}
    o = o.reshape(B, S, di) + p["skip"] * cu
    o = rmsnorm(o, p["out_norm"]) * F.silu(gate)
    return constrain(o @ p["down"], "batch", "seq", "embed"), new_state


def mlstm_state_init(cfg: LMConfig, batch: int, dtype, device=None) -> dict:
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    hd = di // H
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=f32, device=device),
        "m": torch.zeros((batch, H), dtype=f32, device=device),
        "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block_init(gen: torch.Generator, cfg: LMConfig, dtype, device=None) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    dff = int(4 * D / 3)
    return {
        "norm": torch.zeros((D,), dtype=dtype, device=device),
        "w": dense_init(gen, D, 4 * D, dtype, device=device),           # i,f,z,o
        "r": (normal(gen, (4, H, hd, hd), device) / math.sqrt(hd)).to(dtype),
        "out_norm": torch.zeros((D,), dtype=dtype, device=device),
        "ffn_up": dense_init(gen, D, 2 * dff, dtype, device=device),
        "ffn_down": dense_init(gen, dff, D, dtype, device=device),
    }


def _slstm_cell(carry, wx, r):
    """carry: (c,n,h,m) each (B,H,hd); wx: (B,4,H,hd) pre-activations."""
    c, n, h, m = carry
    rh = torch.einsum("ghkv,bhk->bghv", r.float(), h)               # (B,4,H,hd)
    pre = wx.float() + rh
    i_raw, f_raw, z_raw, o_raw = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    m_new = torch.maximum(f_raw + m, i_raw)
    i_ = torch.exp(i_raw - m_new)
    f_ = torch.exp(f_raw + m - m_new)
    c = f_ * c + i_ * torch.tanh(z_raw)
    n = f_ * n + i_
    h = torch.sigmoid(o_raw) * c / torch.clamp_min(n, 1e-6)
    return (c, n, h, m_new)


def slstm_scan(carry, wx, r):
    """The recurrence over a sequence, one token at a time: wx (B,S,4,H,hd)
    -> (h of every token (B,S,H,hd), the final carry)."""
    hs = []
    for wx_t in wx.unbind(1):       # one backward for all tokens (see ``_unstack``)
        carry = _slstm_cell(carry, wx_t, r)
        hs.append(carry[2])
    return torch.stack(hs, dim=1), carry


def slstm_block_apply(p, x, cfg: LMConfig, state=None):
    """Two branches: a loop over the sequence (training, or a prefill that
    returns the final state) and one step (decode)."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    xin = rmsnorm(x, p["norm"])
    wx = (xin @ p["w"]).reshape(B, S, 4, H, hd)

    if state is None or S > 1:
        if state is None:
            carry = tuple(torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
                          for _ in range(4))
        else:
            carry = (state["c"], state["n"], state["h"], state["m"])
        h, carry = slstm_scan(carry, wx, p["r"])
        h = h.reshape(B, S, D).to(x.dtype)
        new_state = None if state is None else {
            "c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
        carry = _slstm_cell(carry, wx[:, 0], p["r"])
        h = carry[2].reshape(B, 1, D).to(x.dtype)
        new_state = {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}

    h = rmsnorm(h, p["out_norm"])
    up, gate = torch.chunk(h @ p["ffn_up"], 2, dim=-1)
    out = (F.gelu(gate, approximate="tanh") * up) @ p["ffn_down"]
    return constrain(out, "batch", "seq", "embed"), new_state


def slstm_state_init(cfg: LMConfig, batch: int, device=None) -> dict:
    H = cfg.num_heads
    hd = cfg.d_model // H
    return {k: torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
            for k in ("c", "n", "h", "m")}
