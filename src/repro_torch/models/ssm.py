"""Mamba-2 (SSD) block — used by zamba2-7b (hybrid) and available standalone.

Chunked SSD algorithm (Dao & Gu, arXiv:2405.21060): within-chunk quadratic
attention-like term + inter-chunk recurrence on (H, N, P) states, carried
by a Python loop over chunks where the JAX package runs ``lax.scan``.
``ssd_reference`` is the O(S) sequential oracle used in tests. Grouped B/C
(``G`` groups broadcast over ``H`` heads: each group repeated in place,
``repeat_interleave``) as in the paper's multi-value variant.

The same operations, in the same order and precision, as the JAX
package's ``models/ssm.py``: the scan, its state and the gates in f32
(``A_log``, ``D`` and ``dt_bias`` are f32 whatever ``cfg.dtype`` is), the
conv cache in ``cfg.dtype``. The products are library matmuls, as ``@``
and ``einsum`` are in JAX: no kernel of this repo lies on this path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.api import constrain
from .lm_config import LMConfig
from .layers import dense_init, normal, rmsnorm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) -> (..., l, l) with out[i,j] = sum_{t=j+1..i} x[t], -inf for j>i."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,      # (B,S,H,P)
    dt: torch.Tensor,     # (B,S,H)  (post-softplus)
    A: torch.Tensor,      # (H,)     (negative)
    Bm: torch.Tensor,     # (B,S,G,N)
    Cm: torch.Tensor,     # (B,S,G,N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B,H,N,P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = S // chunk
    f32 = torch.float32

    xd = (x * dt[..., None]).to(f32)                           # dt-discretized input
    dA = (dt * A[None, None, :]).to(f32)                       # (B,S,H), <= 0

    def to_chunks(t):
        return t.reshape(B, nc, chunk, *t.shape[2:])

    xc, dAc = to_chunks(xd), to_chunks(dA)
    Bc, Cc = to_chunks(Bm.to(f32)), to_chunks(Cm.to(f32))
    Bh = Bc.repeat_interleave(rep, dim=3)                      # (B,nc,l,H,N)
    Ch = Cc.repeat_interleave(rep, dim=3)
    # the G->H broadcast breaks the head-dim sharding chain: re-pin so every
    # intra-chunk quadratic intermediate shards over heads
    Bh = constrain(Bh, "batch", None, None, "heads", None)
    Ch = constrain(Ch, "batch", None, None, "heads", None)
    dAc = constrain(dAc, "batch", None, None, "heads")
    xc = constrain(xc, "batch", None, None, "heads", None)

    cum = torch.cumsum(dAc, dim=2)                             # (B,nc,l,H)
    # ---- intra-chunk (quadratic in chunk length) ----
    L = torch.exp(_segsum(dAc.transpose(2, 3)))                # (B,nc,H,l,l)
    scores = torch.einsum("bnihm,bnjhm->bnhij", Ch, Bh)        # (B,nc,H,l,l)
    y_diag = torch.einsum("bnhij,bnjhp->bnihp", scores * L, xc)

    # ---- chunk states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,l,H)
    states = torch.einsum("bnlhm,bnlhp,bnlh->bnhmp", Bh, xc, decay_to_end)

    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    carry = (torch.zeros((B, H, N, P), dtype=f32, device=x.device) if init_state is None
             else init_state.to(f32))
    entering = []                                              # state *entering* each chunk
    # one backward for all chunks: ``unbind``, not an index per chunk
    for st_c, decay_c in zip(states.unbind(1), chunk_decay.unbind(1)):
        entering.append(carry)
        carry = st_c + decay_c[..., None, None] * carry
    prev_states = torch.stack(entering, dim=1)                 # (B,nc,H,N,P)

    y_off = torch.einsum("bnlhm,bnhmp,bnlh->bnlhp", Ch, prev_states, torch.exp(cum))
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), carry


def ssd_reference(x, dt, A, Bm, Cm, init_state=None):
    """Sequential oracle: state = exp(dt·A)·state + dt·B⊗x ; y = C·state."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    st = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
          if init_state is None else init_state)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])                  # (B,H)
        Bt = Bm[:, t].repeat_interleave(rep, dim=1)            # (B,H,N)
        Ct = Cm[:, t].repeat_interleave(rep, dim=1)
        st = dA[..., None, None] * st + torch.einsum(
            "bhn,bhp->bhnp", Bt, x[:, t] * dt[:, t][..., None])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ct, st))
    return torch.stack(ys, dim=1), st


# ---------------------------------------------------------------------------
# Full Mamba-2 block
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg: LMConfig, dtype, device=None) -> dict:
    """Input projection split into per-role matrices (z/x, B+C, dt), each
    width divisible by the model axis where the fused one is not."""
    D, din, H, N, G = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = din + 2 * G * N
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, D, 2 * din, dtype, device=device),       # z | x
        "bc_proj": dense_init(gen, D, 2 * G * N, dtype, device=device),     # B | C
        "dt_proj": dense_init(gen, D, H, dtype, device=device),
        "conv_w": (normal(gen, (cfg.ssm_conv, conv_dim), device) * 0.1).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "norm": torch.zeros((din,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, din, D, dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor]):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). cache: (B,K-1,C) or None."""
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(K))
    new_cache = xp[:, -(K - 1):] if K > 1 else None
    return out, new_cache


def mamba_apply(
    p: dict,
    x: torch.Tensor,                 # (B,S,D)
    cfg: LMConfig,
    state: Optional[dict] = None,    # {"ssm": (B,H,N,P), "conv": (B,K-1,C)} for decode
) -> Tuple[torch.Tensor, Optional[dict]]:
    B, S, D = x.shape
    din, H, N, G, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    zx = x @ p["in_proj"]
    z, xs = zx[..., :din], zx[..., din:]
    bc = x @ p["bc_proj"]
    Bm, Cm = bc[..., :G * N], bc[..., G * N:]
    dt = x @ p["dt_proj"]
    xBC = torch.cat([xs, Bm, Cm], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], None if state is None else state["conv"])
    xBC = F.silu(xBC)
    xs, Bm, Cm = xBC[..., :din], xBC[..., din:din + G * N], xBC[..., din + G * N:]
    xs = constrain(xs.reshape(B, S, H, P), "batch", "seq", "heads", None)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if state is not None and S == 1:
        # single-step recurrence (decode)
        st = state["ssm"]
        dA = torch.exp(dt[:, 0] * A[None, :])
        rep = H // G
        Bt = Bm[:, 0].repeat_interleave(rep, dim=1)
        Ct = Cm[:, 0].repeat_interleave(rep, dim=1)
        st = dA[..., None, None] * st.float() + torch.einsum(
            "bhn,bhp->bhnp", Bt.float(), (xs[:, 0] * dt[:, 0][..., None]).float())
        y = torch.einsum("bhn,bhnp->bhp", Ct.float(), st)[:, None]
        new_state = {"ssm": st, "conv": new_conv}
    else:
        chunk = min(cfg.ssm_chunk, S)
        if S % chunk:
            chunk = S  # fallback for odd smoke shapes
        init = state["ssm"] if state is not None else None
        y, final = ssd_chunked(xs, dt, A, Bm, Cm, chunk, init_state=init)
        new_state = None if state is None else {"ssm": final, "conv": new_conv}

    y = y.to(x.dtype) + xs * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, din)
    y = rmsnorm(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"]
    return constrain(out, "batch", "seq", "embed"), new_state


def mamba_state_init(cfg: LMConfig, batch: int, dtype, device=None) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
    }
