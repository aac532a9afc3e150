"""Port vs JAX package: the LM front door ``models/lm.py`` over all ten
architectures (prefill and decode, the loss, the HAPM tile groups, the
model-FLOPs count, carrying weights across), the input shapes of
``configs/shapes.py`` for every registry cell, and the serving launchers
``launch/serve.py`` and ``launch/serve_lm.py``.

The JAX side draws the weights (``lm.init``, cached per architecture);
``np.asarray`` of them goes through ``lm.params_from_numpy`` into the port,
and the same numpy inputs go to both. Decode within the JAX package's own
2e-4 (absolute) of JAX's steps and of the port's full forward, as
``tests/test_models_lm.py::test_decode_matches_full_forward`` holds it;
the loss within 1e-5 of JAX's; specs, counts and shapes *equal*. The JAX
side runs jitted."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.configs import shapes as JSH
from repro.models import lm as JLM
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as TSH
from repro_torch.core.masks import tree_flatten_with_path, tree_leaves
from repro_torch.launch import serve, serve_lm
from repro_torch.models import lm as LM

ALL_ARCHS = sorted(JR.REGISTRY)
DECODE_TOL = 2e-4
LOSS_REL_TOL = 1e-5
_PARAMS: dict = {}
J_INIT = jax.jit(JLM.init, static_argnums=(1,))
J_PREFILL = jax.jit(JLM.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(JLM.decode_step, static_argnums=(4,))


def _drop_free(cfg):
    if cfg.family == "moe":
        return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _cfgs(arch):
    return _drop_free(JR.get(arch).smoke), _drop_free(TR.get(arch).smoke)


def _params(arch):
    """(JAX params, the port's: the same weights), once per architecture."""
    if arch not in _PARAMS:
        cfg_j, cfg_t = _cfgs(arch)
        pj = J_INIT(jax.random.PRNGKey(0), cfg_j)
        _PARAMS[arch] = (pj, LM.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                                  device="cpu"))
    return _PARAMS[arch]


def _jax(b):
    return {k: None if v is None else jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: None if v is None else torch.from_numpy(v) for k, v in b.items()}


def _inputs(cfg, B=2, S=16, seed=1):
    """(the prefill batch of the first S/2 positions, the S/2 tokens decoded
    after it, the full batch that the decoded tokens extend it to). The
    audio family's prompt is frame embeddings and its decoded tokens are
    looked up in the embedding table, so its full batch is embeddings."""
    rs = np.random.RandomState(seed)
    half = S // 2
    toks = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        P = cfg.num_prefix_tokens
        img = (rs.randn(B, P, cfg.d_model) * 0.1).astype(np.float32)
        return ({"tokens": toks[:, :half - P], "embeds": img}, toks[:, half - P:S - P],
                {"tokens": toks[:, :S - P], "embeds": img})
    if cfg.family == "audio":
        emb = (rs.randn(B, half, cfg.d_model) * 0.1).astype(np.float32)
        return {"tokens": None, "embeds": emb}, toks[:, half:], None
    return {"tokens": toks[:, :half]}, toks[:, half:], {"tokens": toks}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_matches_jax_and_full_forward(arch):
    """``lm.prefill`` of S/2 positions, then S/2 ``lm.decode_step``s, against
    the JAX package's, step by step, and against the port's own forward
    over the whole sequence (MoE at drop-free capacity)."""
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(arch)
    B, S = 2, 16
    pre, dec, full = _inputs(cfg_j, B, S)
    if full is None:        # audio: the decoded tokens' embeddings extend the frames
        E = pt["embed"][torch.from_numpy(dec).long()].numpy()
        full = {"tokens": None, "embeds": np.concatenate([pre["embeds"], E], axis=1)}
    full_t, _, _ = LM.forward(pt, _torch(full), cfg_t)
    half = S // 2
    lj, cj = J_PREFILL(pj, _jax(pre), cfg_j, S)
    lt, ct = LM.prefill(pt, _torch(pre), cfg_t, max_len=S)
    vs_jax = [float(np.abs(lt.numpy() - np.asarray(lj)).max())]
    vs_full = [float((lt - full_t[:, half - 1]).abs().max())]
    for i in range(dec.shape[1]):
        t = half + i
        lj, cj = J_DECODE(pj, cj, jnp.asarray(dec[:, i]), jnp.full((B,), t, jnp.int32), cfg_j)
        lt, ct = LM.decode_step(pt, ct, torch.from_numpy(dec[:, i]),
                                torch.full((B,), t, dtype=torch.int32), cfg_t)
        vs_jax.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
        vs_full.append(float((lt - full_t[:, t]).abs().max()))
    assert max(vs_jax) < DECODE_TOL, vs_jax
    assert max(vs_full) < DECODE_TOL, vs_full


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_fn_matches_jax(arch):
    """``lm.loss_fn`` (next-token cross entropy, targets < 0 masked) and its
    metrics, the forward-and-loss part of
    ``tests/test_models_lm.py::test_smoke_forward_and_train_step``."""
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(arch)
    pre, _, full = _inputs(cfg_j, seed=7)
    batch = dict(full if full is not None else pre)
    T = (batch["tokens"] if batch.get("tokens") is not None else batch["embeds"]).shape[1]
    targets = np.random.RandomState(8).randint(0, cfg_j.vocab_size, (2, T)).astype(np.int32)
    targets[0, :3] = -1
    batch["targets"] = targets
    loss_j, mj = jax.jit(JLM.loss_fn, static_argnums=(2,))(pj, _jax(batch), cfg_j)
    loss_t, mt = LM.loss_fn(pt, _torch(batch), cfg_t)
    assert np.isfinite(float(loss_t))
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_REL_TOL * abs(float(loss_j))
    assert abs(float(mt["nll"]) - float(mj["nll"])) <= LOSS_REL_TOL * abs(float(mj["nll"]))
    assert float(mt["tokens"]) == float(mj["tokens"]) == 2 * T - 3
    assert abs(float(mt["aux"]) - float(mj["aux"])) <= 1e-5


def _spec_entries(spec):
    if spec is None:
        return None
    return (type(spec).__name__, tuple(spec.shape), spec.kind, spec.num_groups,
            spec.group_size, spec._meta)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_group_specs_equal_jax(arch, smoke):
    """Leaf by leaf: which weights are prunable and their (128, 128) tile
    groups, on the JAX package's tree (shapes only) and the port's (meta)."""
    which = "smoke" if smoke else "config"
    cfg_j, cfg_t = getattr(JR.get(arch), which), getattr(TR.get(arch), which)
    shapes_j = jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cfg_j))
    is_spec = lambda x: x is None or hasattr(x, "num_groups")
    want = {tuple(k.key for k in p): _spec_entries(s) for p, s in
            jax.tree_util.tree_flatten_with_path(JLM.group_specs(shapes_j, cfg_j),
                                                 is_leaf=is_spec)[0]}
    got = {p: _spec_entries(s) for p, s in tree_flatten_with_path(
        LM.group_specs(LM.init(None, cfg_t, device="meta"), cfg_t), is_leaf=is_spec)}
    assert got == want
    assert got[("embed",)] is None
    assert any(s is not None for s in got.values())


def test_model_flops_per_token_equal():
    for arch in ALL_ARCHS:
        for which in ("config", "smoke"):
            cj, ct = getattr(JR.get(arch), which), getattr(TR.get(arch), which)
            assert LM.model_flops_per_token(ct) == JLM.model_flops_per_token(cj)


def _dtypes_jax(cfg):
    tree = jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cfg))
    return {tuple(k.key for k in p): str(l.dtype)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m", "granite-moe-3b-a800m"])
def test_params_from_numpy_keeps_the_dtypes_of_jax_init(arch):
    """On a bf16 copy of the smoke config, every carried leaf has the dtype
    of JAX's ``init``: bf16, but f32 Mamba ``A_log``, ``D``, ``dt_bias`` and
    MoE routers; the values are JAX's rounded once."""
    cfg_j = dataclasses.replace(JR.get(arch).smoke, dtype="bfloat16")
    cfg_t = dataclasses.replace(TR.get(arch).smoke, dtype="bfloat16")
    pj = J_INIT(jax.random.PRNGKey(1), cfg_j)
    pt = LM.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    want = _dtypes_jax(cfg_j)
    got = {p: str(t.dtype).removeprefix("torch.") for p, t in tree_flatten_with_path(pt)}
    assert got == want
    if arch == "zamba2-7b":
        assert got[("mamba", "A_log")] == got[("mamba", "dt_bias")] == "float32"
    flat_j = {tuple(k.key for k in p): np.asarray(l, dtype=np.float32) for p, l in
              jax.tree_util.tree_flatten_with_path(pj)[0]}
    for p, t in tree_flatten_with_path(pt):
        np.testing.assert_array_equal(t.float().numpy(), flat_j[p])


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_params_tree_matches_jax_at_full_width(arch):
    """The port's ``lm.init`` builds the JAX package's tree for the full
    configs: the same keys, shapes and dtypes (meta device against
    ``jax.eval_shape``)."""
    cfg_j, cfg_t = JR.get(arch).config, TR.get(arch).config
    shapes_j = jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cfg_j))
    want = {tuple(k.key for k in p): (l.shape, str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(shapes_j)[0]}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_flatten_with_path(LM.init(None, cfg_t, device="meta"))}
    assert got == want


def test_full_width_counts_of_the_recurrent_card_path():
    """The two full-width recurrent models that the card serves, built on
    the meta device: xlstm-350m at full depth (24 layers: 3 groups of 7
    mLSTM blocks and one sLSTM block), 476 812 288 parameters; zamba2-7b cut
    to 7 of its 81 layers (one super-block of 6 Mamba-2 layers and the
    shared attention, then one tail layer), 907 782 960."""
    for cfg, want in ((TR.get("xlstm-350m").config, 476_812_288),
                      (dataclasses.replace(TR.get("zamba2-7b").config, num_layers=7),
                       907_782_960)):
        p = LM.init(None, cfg, device="meta")
        assert all(t.is_meta for t in tree_leaves(p))
        assert sum(t.numel() for t in tree_leaves(p)) == want, cfg.name
    p = LM.init(None, dataclasses.replace(TR.get("zamba2-7b").config, num_layers=7),
                device="meta")
    assert tuple(p["mamba"]["in_proj"].shape) == (1, 6, 3584, 14336)
    assert tuple(p["mamba_tail"]["in_proj"].shape) == (1, 3584, 14336)


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------

def test_shapes_equal_jax():
    assert list(TSH.SHAPES) == list(JSH.SHAPES)
    for name, sj in JSH.SHAPES.items():
        assert dataclasses.asdict(TSH.SHAPES[name]) == dataclasses.asdict(sj)
    from repro_torch import configs
    assert configs.SHAPES is TSH.SHAPES and configs.input_specs is TSH.input_specs
    assert configs.ShapeSpec is TSH.ShapeSpec


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in JR.cells()],
                         ids=[f"{a}-{s}" for a, s, _ in JR.cells()])
def test_input_specs_equal_jax(arch, shape):
    """Every registry cell at its own config: the same leaves with the same
    shapes and dtypes, meta tensors against ``ShapeDtypeStruct``s (no
    memory allocated on either side)."""
    cfg_j, cfg_t = JR.config_for(arch, shape), TR.config_for(arch, shape)
    want = {tuple(getattr(k, "key", None) for k in p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(
                JSH.input_specs(cfg_j, shape))[0]}
    got_tree = TSH.input_specs(cfg_t, shape)
    leaves = tree_flatten_with_path(got_tree)
    assert all(t.is_meta for _, t in leaves)
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in leaves}
    assert got == want


# ---------------------------------------------------------------------------
# The serving launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b", "mistral-nemo-12b"])
def test_serve_loop_gives_jax_greedy_tokens(arch):
    """``serve.generate`` on the CPU at smoke size, numpy prompts: the same
    greedy tokens as the JAX package's ``lm.prefill``/``lm.decode_step``
    loop (its ``launch/serve.py``) on the same weights."""
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(arch)
    B, P, T = 2, 8, 8
    prompts = np.random.RandomState(9).randint(0, cfg_j.vocab_size, (B, P)).astype(np.int32)
    logits, caches = J_PREFILL(pj, {"tokens": jnp.asarray(prompts)}, cfg_j, P + T)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for i in range(T - 1):
        logits, caches = J_DECODE(pj, caches, tok, jnp.full((B,), P + i, jnp.int32), cfg_j)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    got, _ = serve.generate(pt, cfg_t, torch.from_numpy(prompts), T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.stack(want, 1)))


def test_serve_main_runs_on_the_cpu_and_prints_its_lines(capsys):
    argv = ["--arch", "zamba2-7b", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--max-new", "5"]
    toks = serve.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[prefill] 2x8 in ") and out[0].endswith("s")
    assert out[1].startswith("[decode] 8 tokens in ") and "tok/s" in out[1]
    assert out[2] == f"first row: {toks[0].tolist()}"
    assert tuple(toks.shape) == (2, 5)
    # a draw at temperature > 0 comes from the seeded generator: repeatable
    hot = argv + ["--temperature", "1.0", "--seed", "3"]
    assert torch.equal(serve.main(hot), serve.main(hot))


def test_serve_lm_main_runs_on_the_cpu_and_checks_itself(capsys):
    agree = serve_lm.main(["--arch", "xlstm-350m", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--tokens", "6"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "serving xlstm-350m (smoke config: 4L d=64)"
    assert out[1].startswith("prefill: 2×8 tokens in ")
    assert out[2].startswith("decode: 2×5 tokens in ")
    assert out[3].startswith("sample continuation (row 0): [")
    assert out[4] == f"greedy-path agreement with teacher-forced forward: {agree:.2%}"
    assert agree == 1.0


def test_entry_points_want_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    for arch in ("xlstm-350m", "zamba2-7b"):
        cfg = TR.get(arch).smoke
        with pytest.raises(RuntimeError, match="CUDA"):
            LM.init(0, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            LM.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "xlstm-350m"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(["--arch", "zamba2-7b"])
