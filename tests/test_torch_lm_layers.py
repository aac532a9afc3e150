"""Port vs JAX package: the LM primitives of ``models/layers.py``,
``models/moe.py`` and ``models/frontends.py`` on seeded numpy inputs.

Bars: ``rmsnorm`` within 1e-6 of the output's scale (``torch.rsqrt`` for
``lax.rsqrt``: not the same bits), ``rope`` 1e-6, attention (dense and the
chunked online softmax, with window, softcap and a bidirectional prefix)
5e-6 and its gradient 5e-5, the FFNs 1e-5, the MoE layer 1e-5 with its
routing — experts, ranks, kept slots and buffer slots — *equal*, and the
frontends 1e-6 given JAX's frozen draws. The MoE layer also runs under
``(1, 1)`` sharding rules (the local path) and under ``moe_manual_tp`` (f32
experts, the sum over ``model`` a one-rank ``all_reduce`` on a gloo
group), each against JAX under the same rules."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.dist import api as JAPI, sharding as JSH
from repro.dist.compat import make_mesh
from repro.models import frontends as JF, layers as JL, moe as JM
from repro_torch.configs import registry as TR
from repro_torch.dist import api as TAPI, sharding as TSH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import frontends as TF, layers as TL, moe as TM


def _rs(seed):
    return np.random.RandomState(seed)


def _err(t, j):
    return float(np.abs(t.detach().numpy() - np.asarray(j)).max())


@pytest.mark.parametrize("plus_one", [True, False])
def test_rmsnorm(plus_one):
    rs = _rs(0)
    x = (rs.randn(3, 5, 64) * 3).astype(np.float32)
    w = rs.randn(64).astype(np.float32) * 0.1
    j = np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), plus_one=plus_one))
    t = TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), plus_one=plus_one)
    assert _err(t, j) <= 1e-6 * float(np.abs(j).max())


def test_rmsnorm_keeps_bf16():
    x = torch.from_numpy(_rs(1).randn(2, 8).astype(np.float32)).to(torch.bfloat16)
    assert TL.rmsnorm(x, torch.zeros(8, dtype=torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    rs = _rs(2)
    x = rs.randn(2, 7, 3, 16).astype(np.float32)
    pos = rs.randint(0, 5000, (2, 7)).astype(np.int32)
    j = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    t = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert _err(t, j) <= 1e-6 * max(1.0, float(np.abs(np.asarray(j)).max()))


def _attn_inputs():
    """``tests/test_models_lm.py::test_chunked_attention_matches_dense``'s
    geometry: 8 queries at positions 40..47 over 64 keys, slots 50.. invalid."""
    rs = _rs(3)
    B, Sq, Sk, H, Kv, hd = 2, 8, 64, 4, 2, 16
    q = rs.randn(B, Sq, H, hd).astype(np.float32)
    k = rs.randn(B, Sk, Kv, hd).astype(np.float32)
    v = rs.randn(B, Sk, Kv, hd).astype(np.float32)
    qp = np.broadcast_to(np.arange(40, 40 + Sq, dtype=np.int32)[None], (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Sk, dtype=np.int32)[None], (B, Sk)).copy()
    kp[:, 50:] = -1
    return q, k, v, qp, kp


FLAVORS = [(None, None, 0), (12, 50.0, 4), (None, 30.0, 44), (5, None, 0)]


@pytest.mark.parametrize("window,softcap,prefix", FLAVORS)
def test_attention_core_and_chunked_match_jax(window, softcap, prefix):
    q, k, v, qp, kp = _attn_inputs()
    J = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    T = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    dj = JL.attention_core(*J, window, softcap, prefix)
    dt = TL.attention_core(*T, window, softcap, prefix)
    assert _err(dt, dj) <= 5e-6
    for unroll in (1, 2):
        cj = JL.attention_core_chunked(*J, window, softcap, prefix, chunk=16, unroll=unroll)
        ct = TL.attention_core_chunked(*T, window, softcap, prefix, chunk=16, unroll=unroll)
        assert _err(ct, cj) <= 5e-6
        assert float((ct - dt).abs().max()) <= 5e-6
    # a chunk that does not divide Sk falls back to one chunk of Sk
    ct = TL.attention_core_chunked(*T, window, softcap, prefix, chunk=24)
    assert float((ct - dt).abs().max()) <= 5e-6


def test_chunked_attention_gradient_matches_jax():
    q, k, v, qp, kp = _attn_inputs()
    J = [jnp.asarray(a) for a in (k, v, qp, kp)]
    g_dense = jax.grad(lambda q: jnp.sum(JL.attention_core(q, *J, None, None, 0) ** 2))(
        jnp.asarray(q))
    g_chunk = jax.grad(lambda q: jnp.sum(JL.attention_core_chunked(
        q, *J, None, None, 0, chunk=16) ** 2))(jnp.asarray(q))
    T = [torch.from_numpy(a) for a in (k, v, qp, kp)]
    for fn, want in ((lambda q: TL.attention_core(q, *T, None, None, 0), g_dense),
                     (lambda q: TL.attention_core_chunked(q, *T, None, None, 0, chunk=16),
                      g_chunk)):
        qt = torch.from_numpy(q).requires_grad_(True)
        (fn(qt) ** 2).sum().backward()
        assert torch.isfinite(qt.grad).all()
        assert _err(qt.grad, want) <= 5e-5
        assert _err(qt.grad, g_dense) <= 5e-5


def _smoke(arch, **kw):
    cj, ct = JR.get(arch).smoke, TR.get(arch).smoke
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _attn_params(cfg, seed):
    pj = JL.attn_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


@pytest.mark.parametrize("arch,window,S,W", [
    ("qwen3-32b", None, 6, 12),          # qk-norm, cache longer than the prompt
    ("gemma2-9b", 8, 16, 8),             # S > W: two positions per slot
    ("mistral-nemo-12b", None, 12, 12),
])
def test_attn_apply_with_cache_matches_jax(arch, window, S, W):
    cj, ct = _smoke(arch)
    pj, pt = _attn_params(cj, 7)
    rs = _rs(8)
    B = 2
    x = rs.randn(B, S, cj.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    cache_j = JL.attn_cache_init(cj, B, W, jnp.float32)
    cache_t = TL.attn_cache_init(ct, B, W, torch.float32)
    oj, ncj = JL.attn_apply(pj, jnp.asarray(x), cj, jnp.asarray(pos), window, cache_j)
    ot, nct = TL.attn_apply(pt, torch.from_numpy(x), ct, torch.from_numpy(pos), window, cache_t)
    assert _err(ot, oj) <= 1e-5
    np.testing.assert_array_equal(nct["pos"].numpy(), np.asarray(ncj["pos"]))
    for key in ("k", "v"):
        assert _err(nct[key], ncj[key]) <= 1e-5
    # one decode step through the ring on both sides
    x1 = rs.randn(B, 1, cj.d_model).astype(np.float32)
    p1 = np.full((B, 1), S, np.int32)
    oj, ncj = JL.attn_apply(pj, jnp.asarray(x1), cj, jnp.asarray(p1), window, ncj)
    ot, nct = TL.attn_apply(pt, torch.from_numpy(x1), ct, torch.from_numpy(p1), window, nct)
    assert _err(ot, oj) <= 1e-5
    np.testing.assert_array_equal(nct["pos"].numpy(), np.asarray(ncj["pos"]))


def test_attn_apply_without_cache_and_chunked_branch():
    """No cache: the dense core under ``attn_chunk``, the chunked one past it."""
    cj, ct = _smoke("mistral-nemo-12b", attn_chunk=8)
    pj, pt = _attn_params(cj, 9)
    x = _rs(10).randn(2, 16, cj.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16)).copy()
    oj, _ = JL.attn_apply(pj, jnp.asarray(x), cj, jnp.asarray(pos))
    ot, nc = TL.attn_apply(pt, torch.from_numpy(x), ct, torch.from_numpy(pos))
    assert nc is None and _err(ot, oj) <= 1e-5
    od, _ = TL.attn_apply(pt, torch.from_numpy(x), dataclasses.replace(ct, attn_impl="dense"),
                          torch.from_numpy(pos))
    assert float((ot - od).abs().max()) <= 1e-5


@pytest.mark.parametrize("ffn_type", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_jax(ffn_type):
    cj, ct = _smoke("mistral-nemo-12b", ffn_type=ffn_type)
    pj = JL.ffn_init(jax.random.PRNGKey(11), cj, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    assert set(pj) == set(TL.ffn_init(torch.Generator().manual_seed(0), ct, torch.float32))
    x = _rs(12).randn(2, 5, cj.d_model).astype(np.float32)
    assert _err(TL.ffn_apply(pt, torch.from_numpy(x), ct),
                JL.ffn_apply(pj, jnp.asarray(x), cj)) <= 1e-5


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(arch, T, seed, **kw):
    cj, ct = _smoke(arch, **kw)
    pj = JM.moe_init(jax.random.PRNGKey(seed), cj, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = _rs(seed + 1).randn(T, cj.d_model).astype(np.float32)
    return cj, ct, pj, pt, x


def _jax_routing(x, p, cfg, capacity):
    """The JAX package's ``_moe_local`` dispatch, its statements verbatim."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    logits = x.astype(jnp.float32) @ p["router"]
    gate_vals, eidx = jax.lax.top_k(logits, K)
    onehot = jax.nn.one_hot(eidx, E, dtype=jnp.float32)
    oh = onehot.reshape(T * K, E)
    ranks = jnp.cumsum(oh, axis=0) - oh
    rank = jnp.sum(ranks * oh, axis=-1).astype(jnp.int32)
    keep = rank < capacity
    slot = jnp.where(keep, eidx.reshape(T * K) * capacity + rank, E * capacity)
    return {"eidx": eidx, "rank": rank, "keep": keep, "slot": slot,
            "gates": jax.nn.softmax(gate_vals, axis=-1)}


@pytest.mark.parametrize("arch,T,cap_factor", [
    ("granite-moe-3b-a800m", 32, None),   # capacity factor 2.0: some slots drop
    ("granite-moe-3b-a800m", 40, 0.5),    # capacity 8 against a mean load of 10
    ("mixtral-8x22b", 24, None),
])
def test_moe_local_routing_equal_and_output_matches(arch, T, cap_factor):
    kw = {} if cap_factor is None else {"capacity_factor": cap_factor}
    cj, ct, pj, pt, x = _moe_case(arch, T, 13, **kw)
    cap = JM._capacity(T, cj)
    assert TM._capacity(T, ct) == cap
    want = _jax_routing(jnp.asarray(x), pj, cj, cap)
    got = TM.route(torch.from_numpy(x).float() @ pt["router"], ct, cap)
    for key in ("eidx", "rank", "keep", "slot"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert _err(got["gates"], want["gates"]) <= 1e-6
    oj, aj = JM._moe_local(jnp.asarray(x), pj, cj, cap)
    ot, at = TM._moe_local(torch.from_numpy(x), pt, ct, cap)
    assert _err(ot, oj) <= 1e-5 and abs(float(at) - float(aj)) <= 1e-5
    if cap_factor == 0.5:
        assert not bool(np.asarray(want["keep"]).all())   # the case drops slots


def test_top_k_breaks_ties_to_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = TM.top_k(logits, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_apply_without_rules(arch):
    cj, ct, pj, pt, x = _moe_case(arch, 2 * 12, 17)
    x3 = x.reshape(2, 12, cj.d_model)
    oj, aj = JM.moe_apply(pj, jnp.asarray(x3), cj)
    ot, at = TM.moe_apply(pt, torch.from_numpy(x3), ct)
    assert tuple(ot.shape) == x3.shape
    assert _err(ot, oj) <= 1e-5 and abs(float(at) - float(aj)) <= 1e-5


@pytest.fixture(scope="module")
def meshes():
    """The (1, 1) mesh on both sides: JAX's on its CPU device, the port's
    over a one-rank gloo group."""
    return make_mesh((1, 1), ("data", "model")), make_host_mesh(device="cpu")


@pytest.mark.parametrize("manual_tp", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_apply_under_rules(meshes, arch, manual_tp):
    mj, mt = meshes
    flags = dict(moe_manual_tp=manual_tp)
    cj, ct, pj, pt, x = _moe_case(arch, 2 * 12, 19)
    x3 = x.reshape(2, 12, cj.d_model)
    # jitted, as the JAX package runs its layers under rules (this JAX's
    # eager shard_map refuses the manual-TP region's specs on a (1, 1) mesh)
    with JAPI.use_rules(JSH.make_rules(mj, "serve", JSH.ShardFlags(**flags))):
        oj, aj = jax.jit(lambda p, x: JM.moe_apply(p, x, cj))(pj, jnp.asarray(x3))
    with TAPI.use_rules(TSH.make_rules(mt, "serve", TSH.ShardFlags(**flags))):
        ot, at = TM.moe_apply(pt, torch.from_numpy(x3), ct)
    assert _err(ot, oj) <= 1e-5 and abs(float(at) - float(aj)) <= 1e-5
    plain, _ = TM.moe_apply(pt, torch.from_numpy(x3), ct)
    if not manual_tp:    # one batch shard: the local path, the same bits
        assert torch.equal(ot, plain)


def test_moe_manual_tp_runs_the_experts_in_f32(meshes):
    """In bf16 the manual-TP branch casts to f32 at its boundary (as JAX's
    does), so it differs from the local path's bf16 experts and agrees with
    an f32 run cast back."""
    _, mt = meshes
    _, ct, _, pt, x = _moe_case("granite-moe-3b-a800m", 24, 23)
    x3 = torch.from_numpy(x.reshape(2, 12, -1))
    pb = {k: (v if k == "router" else v.to(torch.bfloat16)) for k, v in pt.items()}
    cb = dataclasses.replace(ct, dtype="bfloat16")
    with TAPI.use_rules(TSH.make_rules(mt, "serve", TSH.ShardFlags(moe_manual_tp=True))):
        manual, _ = TM.moe_apply(pb, x3.to(torch.bfloat16), cb)
    local, _ = TM.moe_apply(pb, x3.to(torch.bfloat16), cb)
    f32, _ = TM.moe_apply({k: v.float() for k, v in pb.items()}, x3.to(torch.bfloat16).float(),
                          ct)
    assert manual.dtype == torch.bfloat16
    assert torch.equal(manual, f32.to(torch.bfloat16))
    assert not torch.equal(manual, local)


# ---------------------------------------------------------------------------
# Frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_prefix,size", [(8, 16), (9, 12), (256, 224)])
def test_siglip_stub_with_jax_weight(n_prefix, size):
    cj, ct = _smoke("paligemma-3b", num_prefix_tokens=n_prefix)
    images = _rs(29).rand(2, size, size, 3).astype(np.float32)
    key = jax.random.PRNGKey(31)
    want = JF.siglip_stub_embed(key, jnp.asarray(images), cj)
    g = max(int(np.ceil(np.sqrt(n_prefix))), 1)
    pd = (max(size // g, 1) ** 2) * 3
    w = np.array(jax.random.normal(key, (pd, cj.d_model)) / np.sqrt(pd))
    got = TF.siglip_stub_embed(None, torch.from_numpy(images), ct, weight=torch.from_numpy(w))
    assert tuple(got.shape) == (2, n_prefix, ct.d_model)
    assert _err(got, want) <= 1e-6 * max(1.0, float(np.abs(np.asarray(want)).max()))
    drawn = TF.siglip_stub_embed(0, torch.from_numpy(images), ct)
    assert drawn.shape == got.shape and torch.equal(
        drawn, TF.siglip_stub_embed(0, torch.from_numpy(images), ct))


def test_encodec_stub_with_jax_tables():
    cj, ct = _smoke("musicgen-medium")
    codes = _rs(37).randint(0, 2048, (2, 9, 4)).astype(np.int32)
    key = jax.random.PRNGKey(41)
    want = JF.encodec_stub_embed(key, jnp.asarray(codes), cj)
    tables = np.array(jax.random.normal(key, (4, 2048, cj.d_model)) * 0.02)
    got = TF.encodec_stub_embed(None, torch.from_numpy(codes), ct,
                                tables=torch.from_numpy(tables))
    assert tuple(got.shape) == (2, 9, ct.d_model)
    assert _err(got, want) <= 1e-6
    assert TF.encodec_stub_embed(3, torch.from_numpy(codes), ct).shape == got.shape
