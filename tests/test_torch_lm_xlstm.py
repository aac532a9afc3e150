"""Port vs JAX package: the xLSTM blocks of ``models/xlstm.py`` (mLSTM in
its parallel and stepwise forms, the mLSTM block's three branches, the
sLSTM block's loop and single step).

The same numpy inputs go to both sides; block weights are drawn by the JAX
package's ``*_init`` and carried across. Module outputs and states within
1e-5 of the largest |value|, and the JAX package's own bar where its test
is mirrored (5e-5 for the parallel form against the recurrence). The JAX
side runs jitted."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import xlstm as JX
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.models import xlstm as TX

REL_TOL = 1e-5
CFG = JR.get("xlstm-350m").smoke
J_MLSTM_BLOCK = jax.jit(JX.mlstm_block_apply, static_argnums=(2,))
J_SLSTM_BLOCK = jax.jit(JX.slstm_block_apply, static_argnums=(2,))


def _close(got: torch.Tensor, want, tol=REL_TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _mlstm_inputs(B=2, S=24, H=2, hd=8, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, H, hd).astype(np.float32) for _ in range(3))
    ig = rs.randn(B, S, H).astype(np.float32)
    fg = (rs.randn(B, S, H) + 1.0).astype(np.float32)
    return q, k, v, ig, fg


def test_mlstm_parallel_matches_jax():
    args = _mlstm_inputs()
    _close(TX.mlstm_parallel(*map(torch.from_numpy, args)),
           jax.jit(JX.mlstm_parallel)(*map(jnp.asarray, args)))


def test_mlstm_step_matches_jax():
    q, k, v, ig, fg = _mlstm_inputs(S=1, seed=1)
    rs = np.random.RandomState(2)
    st = {"C": rs.randn(2, 2, 8, 8).astype(np.float32),
          "n": rs.randn(2, 2, 8).astype(np.float32),
          "m": rs.randn(2, 2).astype(np.float32)}
    one = lambda a: a[:, 0]
    sj, hj = jax.jit(JX.mlstm_step)(jax.tree.map(jnp.asarray, st),
                                     *(jnp.asarray(one(a)) for a in (q, k, v, ig, fg)))
    stt, ht = TX.mlstm_step({k_: torch.from_numpy(a) for k_, a in st.items()},
                            *(torch.from_numpy(one(a)) for a in (q, k, v, ig, fg)))
    _close(ht, hj)
    for key in ("C", "n", "m"):
        _close(stt[key], sj[key])


def test_mlstm_parallel_equals_recurrence():
    """Twin of ``tests/test_models_lm.py::test_mlstm_parallel_equals_recurrence``."""
    q, k, v, ig, fg = map(torch.from_numpy, _mlstm_inputs(seed=3))
    B, S, H, hd = q.shape
    hp = TX.mlstm_parallel(q, k, v, ig, fg)
    st = {"C": torch.zeros((B, H, hd, hd)), "n": torch.zeros((B, H, hd)),
          "m": torch.zeros((B, H))}
    outs = []
    for t in range(S):
        st, h = TX.mlstm_step(st, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        outs.append(h)
    np.testing.assert_allclose(hp.numpy(), torch.stack(outs, 1).numpy(), atol=5e-5)


def _params(init_j, seed):
    pj = init_j(jax.random.PRNGKey(seed), CFG, jnp.float32)
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


def _state(shapes: dict, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*s) * 0.5).astype(np.float32) for k, s in shapes.items()}


def _check_block(apply_j, apply_t, pj, pt, x, state):
    oj, nj = apply_j(pj, jnp.asarray(x), CFG,
                     None if state is None else jax.tree.map(jnp.asarray, state))
    ot, nt = apply_t(pt, torch.from_numpy(x), CFG,
                     None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
    _close(ot, oj)
    if state is None:
        assert nj is None and nt is None
        return
    assert set(nt) == set(nj)
    for k in nj:
        _close(nt[k], nj[k])


@pytest.mark.parametrize("branch", ["no_state", "single_step", "prefill"])
def test_mlstm_block_apply_matches_jax(branch):
    """The three branches: no state (training), one step (decode), and a
    prefill with its closed-form final state."""
    pj, pt = _params(JX.mlstm_block_init, 4)
    B, S = 2, (1 if branch == "single_step" else 12)
    x = np.random.RandomState(5).randn(B, S, CFG.d_model).astype(np.float32)
    di = int(CFG.xlstm_proj_factor * CFG.d_model)
    H = CFG.num_heads
    hd = di // H
    state = None
    if branch == "single_step":
        state = _state({"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H),
                        "conv": (B, 3, di)}, 6)
    elif branch == "prefill":
        state = {k: np.array(v) for k, v in
                 JX.mlstm_state_init(CFG, B, jnp.float32).items()}
    _check_block(J_MLSTM_BLOCK, TX.mlstm_block_apply, pj, pt, x, state)


@pytest.mark.parametrize("branch", ["no_state", "loop_with_state", "single_step"])
def test_slstm_block_apply_matches_jax(branch):
    """The loop over the sequence (with and without a state to carry) and
    the single step."""
    pj, pt = _params(JX.slstm_block_init, 7)
    B, S = 2, (1 if branch == "single_step" else 12)
    x = np.random.RandomState(8).randn(B, S, CFG.d_model).astype(np.float32)
    hd = CFG.d_model // CFG.num_heads
    state = None if branch == "no_state" else _state(
        {k: (B, CFG.num_heads, hd) for k in ("c", "n", "h", "m")}, 9)
    if state is not None:
        state["n"] = np.abs(state["n"]) + 0.5    # a normalizer is positive
    _check_block(J_SLSTM_BLOCK, TX.slstm_block_apply, pj, pt, x, state)


def test_block_and_state_trees_match_jax():
    """Keys, shapes and dtypes of both blocks' weights (``r`` in the model
    dtype) and states (f32 but the conv cache) in bf16."""
    import dataclasses
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    gen = lambda: torch.Generator().manual_seed(0)
    pairs = [
        (lambda: JX.mlstm_block_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16),
         lambda: TX.mlstm_block_init(gen(), cfg, torch.bfloat16, device="cpu")),
        (lambda: JX.slstm_block_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16),
         lambda: TX.slstm_block_init(gen(), cfg, torch.bfloat16, device="cpu")),
        (lambda: JX.mlstm_state_init(cfg, 3, jnp.bfloat16),
         lambda: TX.mlstm_state_init(cfg, 3, torch.bfloat16, device="cpu")),
        (lambda: JX.slstm_state_init(cfg, 3),
         lambda: TX.slstm_state_init(cfg, 3, device="cpu")),
    ]
    for fj, ft in pairs:
        want = {tuple(k.key for k in p): l for p, l in
                jax.tree_util.tree_flatten_with_path(jax.eval_shape(fj))[0]}
        got = dict(tree_flatten_with_path(ft()))
        assert set(got) == set(want)
        for k, leaf in want.items():
            assert tuple(got[k].shape) == leaf.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == str(leaf.dtype), k
