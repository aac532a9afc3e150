"""Port vs JAX package: the Mamba-2 (SSD) block of ``models/ssm.py``.

The same numpy inputs go to both sides; the block's weights are drawn by
the JAX package's ``mamba_init`` and carried across. Module outputs within
1e-5 of the largest |out|, and the JAX package's own bars where its test is
mirrored (2e-4 for the chunk invariance). Grouped B/C with 1 < G < H, so
that a tiled broadcast (``repeat``) in place of the in-place repeat
(``repeat_interleave``) would show: the smoke configs have G = 1."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import ssm as JS
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.models import ssm as TS

REL_TOL = 1e-5
J_SSD = jax.jit(JS.ssd_chunked, static_argnums=(5,))
J_MAMBA = jax.jit(JS.mamba_apply, static_argnums=(2,))


def _close(got: torch.Tensor, want, tol=REL_TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _ssd_inputs(B=2, S=64, H=4, P=8, G=2, N=6, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, H))).astype(np.float32)     # softplus
    A = (-np.exp(rs.randn(H))).astype(np.float32)
    Bm = rs.randn(B, S, G, N).astype(np.float32)
    Cm = rs.randn(B, S, G, N).astype(np.float32)
    s0 = rs.randn(B, H, N, P).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_jax(chunk, with_state):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs()
    init = s0 if with_state else None
    yj, sj = J_SSD(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                            init_state=None if init is None else jnp.asarray(init))
    yt, st = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
                            init_state=None if init is None else torch.from_numpy(init))
    _close(yt, yj)
    _close(st, sj)


def test_ssd_reference_matches_jax():
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(S=24, seed=1)
    yj, sj = JS.ssd_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)), jnp.asarray(s0))
    yt, st = TS.ssd_reference(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), torch.from_numpy(s0))
    _close(yt, yj)
    _close(st, sj)


def test_ssd_chunk_invariance():
    """Twin of ``tests/test_models_lm.py::test_ssd_chunk_invariance``: chunk
    8 and 16 and the sequential oracle agree, at the JAX test's bar."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(seed=2)
    args = tuple(map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    y8, s8 = TS.ssd_chunked(*args, chunk=8)
    y16, _ = TS.ssd_chunked(*args, chunk=16)
    yr, sr = TS.ssd_reference(*args)
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), atol=2e-4)
    np.testing.assert_allclose(y8.numpy(), yr.numpy(), atol=2e-4)
    np.testing.assert_allclose(s8.numpy(), sr.numpy(), atol=2e-4)


def test_grouped_broadcast_repeats_each_group_in_place():
    """Head h reads group h // (H / G): a tiled broadcast would give head 1
    group 1 (with G = 2, H = 4) and fail against the oracle built by hand."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(B=1, S=8, seed=3)
    args = tuple(map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    y, _ = TS.ssd_chunked(*args, chunk=8)
    for h in range(4):
        g = h // 2
        one = TS.ssd_reference(args[0][:, :, h:h + 1], args[1][:, :, h:h + 1],
                               args[2][h:h + 1], args[3][:, :, g:g + 1],
                               args[4][:, :, g:g + 1])[0]
        np.testing.assert_allclose(y[:, :, h:h + 1].numpy(), one.numpy(), atol=2e-4)


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_causal_conv_matches_jax(cached):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 5, 12).astype(np.float32)
    w = rs.randn(4, 12).astype(np.float32)
    cache = rs.randn(2, 3, 12).astype(np.float32) if cached else None
    oj, cj = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if cache is None else jnp.asarray(cache))
    ot, ct = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             None if cache is None else torch.from_numpy(cache))
    _close(ot, oj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def _grouped_cfg():
    """zamba2's smoke config with 16 SSM heads of 8 in 2 groups (G = 1 in
    the registry's)."""
    cfg = dataclasses.replace(JR.get("zamba2-7b").smoke, ssm_head_dim=8)
    assert (cfg.ssm_heads, cfg.ssm_groups) == (16, 2)
    return cfg


def _block(cfg, seed=0):
    pj = JS.mamba_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return pj, pt


@pytest.mark.parametrize("branch", ["full", "stateful_prefill", "single_step"])
def test_mamba_apply_matches_jax(branch):
    cfg = _grouped_cfg()
    pj, pt = _block(cfg)
    rs = np.random.RandomState(5)
    S = 1 if branch == "single_step" else 16
    x = rs.randn(2, S, cfg.d_model).astype(np.float32)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    state = None if branch == "full" else {
        "ssm": (rs.randn(2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim) * 0.5
                ).astype(np.float32),
        "conv": rs.randn(2, cfg.ssm_conv - 1, conv_dim).astype(np.float32)}
    oj, nj = J_MAMBA(pj, jnp.asarray(x), cfg,
                            None if state is None else jax.tree.map(jnp.asarray, state))
    ot, nt = TS.mamba_apply(pt, torch.from_numpy(x), cfg,
                            None if state is None else
                            {k: torch.from_numpy(v) for k, v in state.items()})
    _close(ot, oj)
    if state is None:
        assert nj is None and nt is None
    else:
        for k in ("ssm", "conv"):
            _close(nt[k], nj[k])
            assert str(nt[k].dtype).removeprefix("torch.") == str(nj[k].dtype)


def test_mamba_odd_length_takes_the_whole_sequence_as_one_chunk():
    """S = 12 with ``ssm_chunk`` 8: the fallback ``chunk = S``, as in JAX."""
    cfg = _grouped_cfg()
    pj, pt = _block(cfg, seed=1)
    x = np.random.RandomState(6).randn(2, 12, cfg.d_model).astype(np.float32)
    oj, _ = J_MAMBA(pj, jnp.asarray(x), cfg)
    ot, _ = TS.mamba_apply(pt, torch.from_numpy(x), cfg)
    _close(ot, oj)


def test_mamba_init_and_state_trees_match_jax():
    """Keys, shapes and dtypes: ``A_log``, ``D``, ``dt_bias`` and the SSM
    state in f32 whatever the model dtype, the conv cache in it."""
    cfg = dataclasses.replace(_grouped_cfg(), dtype="bfloat16")
    for fj, ft in ((lambda: JS.mamba_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16),
                    lambda: TS.mamba_init(torch.Generator().manual_seed(0), cfg,
                                          torch.bfloat16, device="cpu")),
                   (lambda: JS.mamba_state_init(cfg, 3, jnp.bfloat16),
                    lambda: TS.mamba_state_init(cfg, 3, torch.bfloat16, device="cpu"))):
        want = {tuple(k.key for k in p): l for p, l in
                jax.tree_util.tree_flatten_with_path(jax.eval_shape(fj))[0]}
        got = dict(tree_flatten_with_path(ft()))
        assert set(got) == set(want)
        for k, leaf in want.items():
            assert tuple(got[k].shape) == leaf.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == str(leaf.dtype), k
