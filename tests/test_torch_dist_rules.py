"""Port vs JAX package: the parallelism vocabulary of ``dist/`` —
``ShardingRules.spec`` (unknown axes, tuple rules, dedupe), the
divisibility fallback, the ``use_rules`` context, ``constrain``, and the
spec derivers ``param_specs`` / ``batch_specs`` / ``cache_specs`` /
``to_shardings``.

Twins of the 18 tests of ``tests/test_dist_rules.py`` and of the four
``dist`` tests of ``tests/test_data_sharding.py`` (same inputs, same
expected specs), on the port's ``(1, 1)`` mesh over a one-rank gloo group.
Then the port's specs against the JAX package's, entry by entry, for all
ten configs, the recurrent families' trees and states included (full and
smoke size) on three meshes
(``(1, 1)``, 16 x 16 and 2 x 16 x 16, the last two shapes only) under
every ``ShardFlags`` toggle; and the port's own additions: the DTensor
placements of a spec, and ``constrain`` on a DTensor."""
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as JR
from repro.dist import sharding as JSH
from repro.dist.compat import make_mesh
from repro.models import lm as JLM
from repro_torch.configs import registry as TR
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.dist.api import (NamedSharding, P, ShardingRules, axes_size, constrain,
                                  current_rules, divisible_spec, placements, use_rules)
from repro_torch.dist.sharding import (ShardFlags, batch_specs, cache_specs, make_rules,
                                       param_specs, to_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm as LM


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


def _mesh():
    return make_host_mesh(device="cpu")


class FakeMesh:
    """axes_size/divisible_spec only consult ``mesh.shape``."""
    shape = {"data": 4, "model": 2}


# ---------------------------------------------------------------------------
# ShardingRules.spec
# ---------------------------------------------------------------------------

def test_spec_unknown_axis_replicates():
    rules = ShardingRules(mesh=_mesh(), rules={"batch": "data"})
    assert rules.spec("nonesuch", "batch") == P(None, "data")
    assert rules.spec(None, "batch", None) == P(None, "data", None)


def test_spec_preserves_tuple_and_string_forms():
    rules = ShardingRules(mesh=_mesh(),
                          rules={"batch": ("pod", "data"), "heads": "model"})
    assert rules.spec("batch", "heads") == P(("pod", "data"), "model")


def test_spec_dedupes_across_dims_first_wins():
    rules = ShardingRules(mesh=_mesh(), rules={"a": "model", "b": "model"})
    assert rules.spec("a", "b") == P("model", None)
    assert rules.spec("b", "a") == P("model", None)


def test_spec_dedupes_tuple_overlap_keeps_remainder():
    rules = ShardingRules(mesh=_mesh(),
                          rules={"x": ("data", "model"), "y": "model"})
    assert rules.spec("y", "x") == P("model", ("data",))
    # fully-consumed tuple comes out replicated, not an empty tuple
    rules2 = ShardingRules(mesh=_mesh(), rules={"x": ("model",), "y": "model"})
    assert rules2.spec("y", "x") == P("model", None)


def test_spec_dedupes_within_one_tuple():
    rules = ShardingRules(mesh=_mesh(), rules={"z": ("data", "data")})
    assert rules.spec("z") == P(("data",))


def test_spec_ignores_boolean_strategy_flags():
    rules = ShardingRules(mesh=_mesh(),
                          rules={"moe_manual_tp": True, "batch": "data"})
    assert rules.spec("moe_manual_tp", "batch") == P(None, "data")


# ---------------------------------------------------------------------------
# Divisibility fallback
# ---------------------------------------------------------------------------

def test_axes_size():
    assert axes_size(FakeMesh, None) == 1
    assert axes_size(FakeMesh, "data") == 4
    assert axes_size(FakeMesh, ("data", "model")) == 8


def test_divisible_spec_replicates_indivisible_dims():
    assert divisible_spec(P("data", "model"), (8, 3), FakeMesh) == P("data", None)
    assert divisible_spec(P(("data", "model"),), (16,), FakeMesh) == P(("data", "model"),)
    assert divisible_spec(P(("data", "model"),), (12,), FakeMesh) == P(None)
    # spec longer than rank: extra entries replicate instead of erroring
    assert divisible_spec(P("data", "model"), (8,), FakeMesh) == P("data", None)


# ---------------------------------------------------------------------------
# use_rules / constrain
# ---------------------------------------------------------------------------

def test_constrain_identity_without_rules():
    x = torch.ones((4, 6))
    assert current_rules() is None
    assert constrain(x, "batch", "embed") is x


def test_constrain_noop_under_none_rules():
    x = torch.ones((4,))
    with use_rules(None):
        assert constrain(x, "batch") is x


def test_use_rules_nesting_restores_outer():
    outer = ShardingRules(mesh=_mesh(), rules={"batch": "data"})
    inner = ShardingRules(mesh=_mesh(), rules={"batch": "model"})
    with use_rules(outer):
        assert current_rules() is outer
        with use_rules(inner):
            assert current_rules() is inner
        assert current_rules() is outer
    assert current_rules() is None


def test_use_rules_pops_on_exception():
    rules = ShardingRules(mesh=_mesh(), rules={})
    with pytest.raises(RuntimeError):
        with use_rules(rules):
            raise RuntimeError("boom")
    assert current_rules() is None


def test_constrain_applies_and_preserves_values():
    rules = make_rules(_mesh(), "train", ShardFlags())
    x = torch.arange(12.0).reshape(4, 3)
    with use_rules(rules):
        y = constrain(x, "batch", "embed")
    assert torch.equal(y, x)


def test_constrain_rejects_rank_mismatch():
    rules = make_rules(_mesh(), "train", ShardFlags())
    with use_rules(rules):
        with pytest.raises(ValueError):
            constrain(torch.ones((4,)), "batch", "seq")


def test_constrain_inside_a_function_runs_eagerly():
    """Twin of ``test_constrain_inside_jit_compiles``: the port runs the
    same function eagerly (it compiles nothing)."""
    rules = make_rules(_mesh(), "train", ShardFlags())

    def f(x):
        return constrain(x, "batch", "embed") * 2.0

    with use_rules(rules):
        out = f(torch.ones((4, 3)))
    assert torch.equal(out, 2.0 * torch.ones((4, 3)))


# ---------------------------------------------------------------------------
# make_rules / batch_specs / cache_specs / to_shardings
# ---------------------------------------------------------------------------

def test_make_rules_flags_and_modes():
    mesh = _mesh()
    base = make_rules(mesh, "train", ShardFlags())
    assert base.rules["batch"] == ("data",)
    assert base.rules["heads"] == "model" and base.rules["fsdp"] == "data"
    assert base.rules["seq"] is None and "moe_manual_tp" not in base.rules

    sp = make_rules(mesh, "train", ShardFlags(sp=True))
    assert sp.rules["seq"] == "model"
    assert make_rules(mesh, "decode", ShardFlags(sp=True)).rules["seq"] is None

    off = make_rules(mesh, "train", ShardFlags(fsdp=False, tp=False))
    assert off.rules["fsdp"] is None and off.rules["heads"] is None

    moe = make_rules(mesh, "train", ShardFlags(moe_manual_tp=True))
    assert moe.rules["moe_manual_tp"] is True

    with pytest.raises(ValueError):
        make_rules(mesh, "sideways", ShardFlags())


def test_batch_specs_layout_and_none_passthrough():
    rules = make_rules(_mesh(), "train", ShardFlags())
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "embeds": None,
             "scalar": torch.zeros(())}
    specs = batch_specs(batch, rules)
    assert specs["tokens"] == P(("data",), None)
    assert specs["embeds"] is None
    assert specs["scalar"] == P()
    shardings = to_shardings(specs, rules.mesh)
    assert shardings["embeds"] is None
    assert shardings["tokens"].spec == P(("data",), None)


def test_cache_specs_kv_and_state_layouts():
    rules = make_rules(_mesh(), "decode", ShardFlags(state_shard=True))
    caches = {
        "k": torch.zeros((2, 8, 32, 4, 16)),       # (L,B,W,Kv,hd)
        "v": torch.zeros((2, 8, 32, 4, 16)),
        "pos": torch.zeros((2, 8, 32), dtype=torch.int32),  # (L,B,W)
        "mamba": {"ssm": torch.zeros((3, 2, 8, 4, 8, 16)),   # (...,B,H,N,P)
                  "conv": torch.zeros((3, 2, 8, 3, 64))},    # (...,B,K-1,C)
        "slstm": {"m": torch.zeros((3, 8, 4, 16))},          # (G,B,H,hd)
    }
    specs = cache_specs(caches, rules)
    assert specs["k"] == P(None, ("data",), None, "model", None)
    assert specs["pos"] == P(None, ("data",), None)
    assert specs["mamba"]["ssm"] == P(None, None, ("data",), "model", None, None)
    assert specs["mamba"]["conv"] == P(None, None, ("data",), None, "model")
    assert specs["slstm"]["m"] == P(None, ("data",), "model", None)
    # without the flag, feature dims replicate
    plain = cache_specs(caches, make_rules(_mesh(), "decode", ShardFlags()))
    assert plain["k"] == P(None, ("data",), None, None, None)


# ---------------------------------------------------------------------------
# The dist tests of tests/test_data_sharding.py
# ---------------------------------------------------------------------------

def test_rules_spec_and_dedupe():
    rules = ShardingRules(mesh=_mesh(), rules={"batch": ("data",), "heads": "model",
                                               "seq": "model"})
    assert rules.spec("batch", "seq", "heads") == P(("data",), "model", None)
    assert rules.spec("batch", None, "heads") == P(("data",), None, "model")


def test_constrain_noop_without_rules():
    x = torch.ones((4, 4))
    assert constrain(x, "batch", "embed") is x


def test_param_specs_patterns():
    cfg = TR.get("qwen3-32b").smoke
    params = LM.init(None, cfg, device="meta")
    rules = make_rules(_mesh(), "train", ShardFlags())
    specs = param_specs(params, rules)
    # embedding: vocab over model, fsdp over data — but smoke dims don't divide,
    # the fallback must replicate rather than fail
    assert isinstance(specs["embed"], P)
    blk = specs["blocks"]
    assert isinstance(blk["attn"]["wq"], P)
    assert blk["ln1"] == P(None, None)


def test_param_specs_full_config_divisible():
    rules = ShardingRules(mesh=_mesh(), rules={"batch": ("data",), "heads": "model",
                                               "ffn": "model", "vocab": "model",
                                               "fsdp": "data"})
    cfg = TR.get("qwen3-32b").config
    specs = param_specs(LM.init(None, cfg, device="meta"), rules)
    blk = specs["blocks"]
    # col-parallel: (L, D, H*hd) -> (None, fsdp, model); sizes divide at 16x16
    assert blk["attn"]["wq"] == P(None, "data", "model")
    assert blk["attn"]["wo"] == P(None, "model", "data")
    assert blk["ffn"]["wi"] == P(None, "data", "model")
    assert specs["embed"] == P("model", "data")


# ---------------------------------------------------------------------------
# Port specs == JAX specs, entry by entry
# ---------------------------------------------------------------------------

class FakeMesh16:
    """A 16 x 16 production mesh, shapes only (both packages' derivers read
    ``shape`` and ``axis_names`` alone)."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class FakeMesh2x16:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


ALL_ARCHS = sorted(JR.REGISTRY)
FLAG_SETS = [{}, {"fsdp": False}, {"tp": False}, {"sp": True}, {"state_shard": True},
             {"moe_manual_tp": True}, {"opt_bf16": True}]
_SHAPES: dict = {}


def _trees(arch, smoke):
    """(JAX params/caches/batch as shapes, the port's on the meta device)."""
    key = (arch, smoke)
    if key not in _SHAPES:
        cj, ct = (getattr(R.get(arch), "smoke" if smoke else "config") for R in (JR, TR))
        B, S = (4, 16) if smoke else (64, 512)
        jp = jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cj))
        jc = jax.eval_shape(lambda: JLM.init_caches(cj, B, S))
        tp = LM.init(None, ct, device="meta")
        tc = LM.init_caches(ct, B, S, device="meta")
        emb = cj.num_prefix_tokens if cj.family == "vlm" else S
        jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "targets": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "embeds": (jax.ShapeDtypeStruct((B, emb, cj.d_model), jnp.float32)
                         if cj.family in ("vlm", "audio") else None)}
        tb = {k: None if v is None else torch.empty(v.shape, device="meta")
              for k, v in jb.items()}
        _SHAPES[key] = ((jp, jc, jb), (tp, tc, tb))
    return _SHAPES[key]


def _entries(spec):
    """A spec's entries, a one-name tuple written as the name (this JAX's
    ``PartitionSpec`` iterates ``("data",)`` as ``"data"``; both mean the
    same split)."""
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None or isinstance(x, JP))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): _entries(s)
            for p, s in leaves}


def _flat_port(tree):
    return {p: _entries(s) for p, s in
            tree_flatten_with_path(tree, is_leaf=lambda x: x is None or isinstance(x, P))}


@pytest.mark.parametrize("mesh_name", ["1x1", "16x16", "2x16x16"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_jax_entry_by_entry(mesh, arch, smoke, mesh_name):
    meshes = {"1x1": (make_mesh((1, 1), ("data", "model")), mesh),
              "16x16": (FakeMesh16, FakeMesh16), "2x16x16": (FakeMesh2x16, FakeMesh2x16)}
    mj, mt = meshes[mesh_name]
    (jp, jc, jb), (tp, tc, tb) = _trees(arch, smoke)
    for flags in FLAG_SETS:
        for mode in ("train", "decode"):
            rj = JSH.make_rules(mj, mode, JSH.ShardFlags(**flags))
            rt = make_rules(mt, mode, ShardFlags(**flags))
            assert rj.rules == rt.rules
            for derive_j, derive_t, tj, tt in (
                    (JSH.param_specs, param_specs, jp, tp),
                    (JSH.cache_specs, cache_specs, jc, tc),
                    (JSH.batch_specs, batch_specs, jb, tb)):
                want, got = _flat_jax(derive_j(tj, rj)), _flat_port(derive_t(tt, rt))
                assert got == want, (derive_t.__name__, flags, mode)
    if mesh_name != "1x1" and not smoke:
        # the production meshes really shard the full configs
        specs = _flat_port(param_specs(tp, make_rules(mt, "train")))
        assert any(s and any(e is not None for e in s) for s in specs.values())


# ---------------------------------------------------------------------------
# The port's own: DTensor placements, constrain on a DTensor
# ---------------------------------------------------------------------------

def test_placements_of_specs(mesh):
    from torch.distributed.tensor import Replicate, Shard
    assert placements(P(("data",), None), mesh) == (Shard(0), Replicate())
    assert placements(P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert placements(P(("data", "model")), mesh) == (Shard(0), Shard(0))
    assert placements(P(), mesh) == (Replicate(), Replicate())
    assert NamedSharding(mesh, P("model", "data")).placements == (Shard(1), Shard(0))
    with pytest.raises(ValueError, match="dim order"):
        placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="does not have"):
        placements(P("pod"), mesh)


def test_constrain_redistributes_a_dtensor(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.arange(24.0).reshape(4, 6)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with use_rules(make_rules(mesh, "train")):
        y = constrain(d, "batch", "embed")
        z = constrain(y, None, "heads")
    assert y.placements == (Shard(0), Replicate())
    assert z.placements == (Replicate(), Shard(1))
    assert torch.equal(z.full_tensor(), x)
