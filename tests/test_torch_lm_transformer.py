"""Port vs JAX package: the transformer LM family (dense, MoE, VLM, audio)
of ``models/transformer.py``, its serving entry points (``models/lm.py``'s
``prefill``/``decode_step``), the config copy (``models/lm_config.py``) and
the architecture registry (``configs/registry.py``). The forward tests and
the tree test go through the front door (``lm.init``/``lm.forward``) and
so cover the recurrent families (xLSTM, the Zamba-2 hybrid) too.

The JAX side draws the weights (``lm.init``); ``np.asarray`` of them goes
through ``lm.params_from_numpy`` into the port, and the same numpy inputs
go to both. Logits within 1e-4 of the largest |logit| (f32 smoke
configs), the MoE aux loss within 1e-5; decode against the full forward
within 2e-4, as ``tests/test_models_lm.py`` holds the JAX package. The
registry and the config copy are held *equal*."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import lm as JLM, lm_config as JLC
from repro_torch.configs import registry as TR
from repro_torch.models import lm as LM, lm_config as TLC, transformer as TT

LOGIT_REL_TOL = 1e-4
AUX_TOL = 1e-5
DECODE_TOL = 2e-4

TRANSFORMER_ARCHS = sorted(a for a, e in JR.REGISTRY.items()
                           if e.smoke.family not in ("ssm", "hybrid"))
ALL_ARCHS = sorted(JR.REGISTRY)
# the JAX side's init and forward run jitted: one compile, where the eager
# ops of the recurrent families' scans compile one by one
J_INIT = jax.jit(JLM.init, static_argnums=(1,))
J_FORWARD = jax.jit(JLM.forward, static_argnums=(2,))


def _batch_np(cfg, B=2, S=16, seed=1):
    rs = np.random.RandomState(seed)
    if cfg.family == "audio":
        return {"tokens": None,
                "embeds": (rs.randn(B, S, cfg.d_model) * 0.1).astype(np.float32)}
    if cfg.family == "vlm":
        P = cfg.num_prefix_tokens
        return {"tokens": rs.randint(0, cfg.vocab_size, (B, S - P)).astype(np.int32),
                "embeds": (rs.randn(B, P, cfg.d_model) * 0.1).astype(np.float32)}
    return {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jax(b):
    return {k: None if v is None else jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: None if v is None else torch.from_numpy(v) for k, v in b.items()}


def _both_params(arch, cfg_j, cfg_t, seed=0):
    pj = J_INIT(jax.random.PRNGKey(seed), cfg_j)
    return pj, LM.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_jax(arch):
    cfg_j, cfg_t = JR.get(arch).smoke, TR.get(arch).smoke
    pj, pt = _both_params(arch, cfg_j, cfg_t)
    b = _batch_np(cfg_j)
    lj, cj, aj = J_FORWARD(pj, _jax(b), cfg_j)
    lt, ct, at = LM.forward(pt, _torch(b), cfg_t)
    lj = np.asarray(lj)
    assert cj is None and ct is None
    assert tuple(lt.shape) == lj.shape and lt.dtype == torch.float32
    err = float(np.abs(lt.numpy() - lj).max())
    assert err <= LOGIT_REL_TOL * float(np.abs(lj).max()), (arch, err)
    assert abs(float(at) - float(aj)) <= AUX_TOL
    if cfg_j.family == "moe":
        assert float(at) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_with_caches_matches_jax(arch):
    """One forward through fresh caches (a prefill) on both sides: logits
    and every cache leaf (k, v and the slots' positions; the recurrent
    families' leaves within 1e-5 of their largest |value|) agree."""
    cfg_j, cfg_t = JR.get(arch).smoke, TR.get(arch).smoke
    pj, pt = _both_params(arch, cfg_j, cfg_t, seed=2)
    b = _batch_np(cfg_j, seed=3)
    S = sum(v.shape[1] for v in b.values() if v is not None)
    lj, cj, _ = J_FORWARD(pj, _jax(b), cfg_j, JLM.init_caches(cfg_j, 2, S + 4))
    lt, ct, _ = LM.forward(pt, _torch(b), cfg_t,
                           caches=LM.init_caches(cfg_t, 2, S + 4, device="cpu"))
    lj = np.asarray(lj)
    assert float(np.abs(lt.numpy() - lj).max()) <= LOGIT_REL_TOL * float(np.abs(lj).max())
    flat_j = jax.tree_util.tree_flatten_with_path(cj)[0]
    from repro_torch.core.masks import tree_flatten_with_path
    flat_t = dict(tree_flatten_with_path(ct))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        key = tuple(k.key for k in path)
        got, want = flat_t[key].numpy(), np.asarray(leaf)
        if key[-1] == "pos":
            np.testing.assert_array_equal(got, want)
        elif cfg_j.family in ("ssm", "hybrid"):
            # the recurrent states, and the shared attention's k, v behind
            # Mamba layers: x the leaf's largest |value|
            np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()),
                                       rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _drop_free(cfg):
    if cfg.family == "moe":
        return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


@pytest.mark.parametrize("arch", [a for a in TRANSFORMER_ARCHS
                                  if JR.get(a).smoke.family in ("dense", "moe")])
def test_prefill_decode_matches_jax_and_full_forward(arch):
    """``prefill`` then ``decode_step`` against the JAX package's
    ``lm.prefill``/``lm.decode_step`` step by step, and against the port's
    own full forward (MoE at drop-free capacity, as in
    ``tests/test_models_lm.py``)."""
    cfg_j, cfg_t = _drop_free(JR.get(arch).smoke), _drop_free(TR.get(arch).smoke)
    pj, pt = _both_params(arch, cfg_j, cfg_t, seed=0)
    B, S = 2, 16
    toks = np.random.RandomState(4).randint(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    full_t, _, _ = TT.forward(pt, {"tokens": torch.from_numpy(toks)}, cfg_t)
    lj, cj = JLM.prefill(pj, {"tokens": jnp.asarray(toks[:, :S // 2])}, cfg_j, max_len=S)
    lt, ct = LM.prefill(pt, {"tokens": torch.from_numpy(toks[:, :S // 2])}, cfg_t, max_len=S)
    vs_jax = [float(np.abs(lt.numpy() - np.asarray(lj)).max())]
    vs_full = [float((lt - full_t[:, S // 2 - 1]).abs().max())]
    for t in range(S // 2, S):
        lj, cj = JLM.decode_step(pj, cj, jnp.asarray(toks[:, t]),
                                 jnp.full((B,), t, jnp.int32), cfg_j)
        lt, ct = LM.decode_step(pt, ct, torch.from_numpy(toks[:, t]),
                                torch.full((B,), t, dtype=torch.int32), cfg_t)
        vs_jax.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
        vs_full.append(float((lt - full_t[:, t]).abs().max()))
    assert max(vs_jax) < DECODE_TOL, vs_jax
    assert max(vs_full) < DECODE_TOL, vs_full


def test_prefill_longer_than_the_window_matches_jax():
    """A prefill of 16 positions into gemma2's 8-slot local ring (S > W):
    two positions of a row share each slot and the later one wins, as JAX's
    scatter applies them in order; then decode steps wrap the ring."""
    arch = "gemma2-9b"
    cfg_j, cfg_t = JR.get(arch).smoke, TR.get(arch).smoke
    assert cfg_j.sliding_window == 8
    pj, pt = _both_params(arch, cfg_j, cfg_t, seed=5)
    B, S = 2, 16
    toks = np.random.RandomState(6).randint(0, cfg_j.vocab_size, (B, S + 4)).astype(np.int32)
    lj, cj = JLM.prefill(pj, {"tokens": jnp.asarray(toks[:, :S])}, cfg_j, max_len=S + 4)
    lt, ct = LM.prefill(pt, {"tokens": torch.from_numpy(toks[:, :S])}, cfg_t, max_len=S + 4)
    assert tuple(ct["local"]["k"].shape[2:3]) == (8,)
    np.testing.assert_array_equal(ct["local"]["pos"].numpy(), np.asarray(cj["local"]["pos"]))
    np.testing.assert_allclose(ct["local"]["k"].numpy(), np.asarray(cj["local"]["k"]),
                               atol=1e-5, rtol=0)
    errs = [float(np.abs(lt.numpy() - np.asarray(lj)).max())]
    for t in range(S, S + 4):
        lj, cj = JLM.decode_step(pj, cj, jnp.asarray(toks[:, t]),
                                 jnp.full((B,), t, jnp.int32), cfg_j)
        lt, ct = LM.decode_step(pt, ct, torch.from_numpy(toks[:, t]),
                                torch.full((B,), t, dtype=torch.int32), cfg_t)
        errs.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
    np.testing.assert_array_equal(ct["local"]["pos"].numpy(), np.asarray(cj["local"]["pos"]))
    assert max(errs) < DECODE_TOL, errs


def test_params_tree_and_shapes_match_jax():
    """The port's own ``init`` builds the JAX package's tree: the same keys,
    shapes and dtypes (routers and Mamba's ``A_log``, ``D``, ``dt_bias``
    f32), for every architecture."""
    for arch in ALL_ARCHS:
        cfg_j, cfg_t = JR.get(arch).smoke, TR.get(arch).smoke
        shapes_j = jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cfg_j))
        flat_j = {tuple(k.key for k in p): l for p, l in
                  jax.tree_util.tree_flatten_with_path(shapes_j)[0]}
        from repro_torch.core.masks import tree_flatten_with_path
        flat_t = dict(tree_flatten_with_path(LM.init(0, cfg_t, device="cpu")))
        assert set(flat_j) == set(flat_t), arch
        for k, leaf in flat_j.items():
            assert tuple(flat_t[k].shape) == leaf.shape, (arch, k)
            assert str(flat_t[k].dtype).removeprefix("torch.") == str(leaf.dtype), (arch, k)


def test_entry_points_want_the_card_by_default():
    cfg = TR.get("mistral-nemo-12b").smoke
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_caches(cfg, 1, 8)


def test_lm_config_copy_defaults_and_counts_equal():
    fields_j = {f.name: f.default for f in dataclasses.fields(JLC.LMConfig)}
    fields_t = {f.name: f.default for f in dataclasses.fields(TLC.LMConfig)}
    assert fields_j == fields_t
    for arch in JR.REGISTRY:
        for which in ("config", "smoke"):
            cj, ct = getattr(JR.get(arch), which), getattr(TR.get(arch), which)
            assert cj.param_count() == ct.param_count(), (arch, which)
            assert cj.active_param_count() == ct.active_param_count(), (arch, which)
            assert (cj.d_inner, cj.ssm_heads, cj.ssm_groups) == \
                (ct.d_inner, ct.ssm_heads, ct.ssm_groups)


def test_registry_equal_field_by_field():
    assert list(JR.REGISTRY) == list(TR.REGISTRY)
    for arch, ej in JR.REGISTRY.items():
        et = TR.REGISTRY[arch]
        assert dataclasses.asdict(ej.config) == dataclasses.asdict(et.config), arch
        assert dataclasses.asdict(ej.smoke) == dataclasses.asdict(et.smoke), arch
        assert (ej.shapes, ej.shape_overrides, ej.skips) == \
            (et.shapes, et.shape_overrides, et.skips)
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k", None):
            for smoke in (False, True):
                assert dataclasses.asdict(JR.config_for(arch, shape, smoke)) == \
                    dataclasses.asdict(TR.config_for(arch, shape, smoke))
    assert JR.cells() == TR.cells()
    assert JR.cells(include_skips=True) == TR.cells(include_skips=True)
    with pytest.raises(KeyError):
        TR.get("nonesuch")


def test_per_arch_config_modules_equal():
    import importlib
    for mod in ("gemma2_9b", "gemma_7b", "granite_moe_3b_a800m", "mistral_nemo_12b",
                "mixtral_8x22b", "musicgen_medium", "paligemma_3b", "qwen3_32b",
                "xlstm_350m", "zamba2_7b"):
        mj = importlib.import_module(f"repro.configs.{mod}")
        mt = importlib.import_module(f"repro_torch.configs.{mod}")
        assert dataclasses.asdict(mj.CONFIG) == dataclasses.asdict(mt.CONFIG)
        assert dataclasses.asdict(mj.SMOKE) == dataclasses.asdict(mt.SMOKE)
        assert (mj.SHAPES, mj.SHAPE_OVERRIDES, mj.SKIPS) == \
            (mt.SHAPES, mt.SHAPE_OVERRIDES, mt.SKIPS)


def test_param_counts_sane():
    """Twin of ``tests/test_models_lm.py::test_param_counts_sane``."""
    for arch in sorted(TR.REGISTRY):
        cfg = TR.get(arch).config
        n = cfg.param_count()
        assert n > 1e8, f"{arch}: {n}"
        if cfg.family == "moe":
            assert cfg.active_param_count() < n


def test_full_width_counts_of_the_card_path():
    """The two full-width models that the card runs with 2 layers, built on
    the meta device (shapes only): mistral-nemo-12b 1.22 G parameters
    (embedding 671 M, 272.6 M a layer), granite-moe-3b-a800m 277 M — the
    config's analytic count plus the final norm."""
    from repro_torch.core.masks import tree_leaves
    for arch, embed, per_layer in (("mistral-nemo-12b", 671_088_640, 272_640_000),
                                   ("granite-moe-3b-a800m", 75_502_080, 100_727_808)):
        cfg = dataclasses.replace(TR.get(arch).config, num_layers=2)
        p = TT.init(None, cfg, device="meta")
        assert all(t.is_meta for t in tree_leaves(p))
        n = sum(t.numel() for t in tree_leaves(p))
        assert cfg.param_count() == embed + 2 * per_layer, arch
        assert n == cfg.param_count() + cfg.d_model, arch
