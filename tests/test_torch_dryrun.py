"""Port vs JAX package: the dry-run (``launch/dryrun.py``), its analysis
(``launch/analysis.py``) and the roofline table twin
(``benchmarks/bench_roofline_torch.py``).

Twins of ``tests/test_dryrun_small.py``: the roofline terms and dominance
(at one H100's constants) and the model-FLOPs conventions. Two of its tests
have no counterpart. ``test_parse_collectives_counts_and_bytes`` holds the
parser of XLA's HLO text; PyTorch runs eagerly and writes no HLO, and the
port's dry-run does not model collectives (``analysis.py``'s docstring).
``test_multidevice_compile_and_probe_linearity`` compiles on eight faked
XLA devices and checks the unroll probes' linearity; the port compiles
nothing and has no probes (its walk runs every layer), so its linearity
half is held here on the walk itself, exactly:
flops(4 layers) - flops(2) = 2 (flops(2) - flops(1)).

Equal to the JAX package's: ``model_flops`` for every architecture and
kind, ``_slstm_correction`` for every cell, and the argument bytes per
device of every registry cell on both production meshes, computed from the
JAX package's ``param_specs`` / ``batch_specs`` / ``cache_specs`` over its
``eval_shape`` trees."""
import dataclasses
import json
import math
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
from jax.sharding import PartitionSpec as JP

from benchmarks import bench_roofline, bench_roofline_torch
from repro.configs import registry as JR
from repro.configs import shapes as JSHP
from repro.dist import sharding as JSH
from repro.launch import analysis as JAN
from repro.launch import train as JT
from repro.models import lm as JLM
from repro_torch.configs import registry as TR
from repro_torch.configs import shapes as TSHP
from repro_torch.dist import sharding as TSH
from repro_torch.launch import analysis as AN
from repro_torch.launch import dryrun as DR

ALL_ARCHS = sorted(JR.REGISTRY)
CELLS = [(a, s) for a, s, _ in JR.cells()]


class FakeMesh16:
    """The JAX package's 16 x 16 production mesh, shapes only."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class FakeMesh2x16:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


JAX_MESHES = {False: FakeMesh16, True: FakeMesh2x16}


# ---------------------------------------------------------------------------
# analysis.py
# ---------------------------------------------------------------------------

def test_roofline_terms_and_dominance():
    """``test_roofline_terms_and_dominance`` at one H100's peaks (bf16 half
    the int8 row, 3.35 TB/s, 900 GB/s NVLink); with the collective term not
    modeled (``None``) dominance is taken over the other two."""
    assert AN.PEAK_FLOPS == 989.5e12 and AN.PEAK_INT8 == 1979e12
    assert AN.HBM_BW == 3.35e12 and AN.LINK_BW == 900e9
    r = AN.Roofline(chips=256, flops=AN.PEAK_FLOPS * 256, bytes=AN.HBM_BW * 256,
                    coll_bytes=0.0)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory")
    r2 = AN.Roofline(chips=2, flops=1, bytes=1, coll_bytes=AN.LINK_BW * 2 * 5)
    assert r2.dominant == "collective" and r2.t_collective == pytest.approx(5.0)
    r3 = AN.Roofline(chips=2, flops=AN.PEAK_FLOPS * 2, bytes=AN.HBM_BW * 4, coll_bytes=None)
    assert r3.t_collective is None and r3.dominant == "memory"
    assert r3.t_bound == pytest.approx(2.0)
    d = r3.as_dict()
    assert d["t_collective_s"] is None and d["collective_bytes"] is None


def test_model_flops_conventions():
    cfg = TR.get("mistral-nemo-12b").config
    t = AN.model_flops(cfg, "train", 4096, 256)
    p = AN.model_flops(cfg, "prefill", 4096, 256)
    d = AN.model_flops(cfg, "decode", 32768, 128)
    assert t > 2.9 * p                # 6N vs 2N + attn
    assert d < p
    moe = TR.get("mixtral-8x22b").config
    assert AN.model_flops(moe, "train", 4096, 256) < 6.0 * moe.param_count() * 4096 * 256


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_equal_jax(arch):
    for which in ("config", "smoke"):
        cj, ct = getattr(JR.get(arch), which), getattr(TR.get(arch), which)
        assert AN._attn_layer_count(ct) == JAN._attn_layer_count(cj)
        for sp in JSHP.SHAPES.values():
            for kind in ("train", "prefill", "decode"):
                assert AN.model_flops(ct, kind, sp.seq_len, sp.global_batch) == \
                    JAN.model_flops(cj, kind, sp.seq_len, sp.global_batch), (which, kind)


def test_device_peaks_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    peaks = AN.device_peaks()
    assert peaks["device"] is None and peaks["memory_bytes"] == 80 * 1024 ** 3
    assert DR.hbm_per_chip() == 80 * 1024 ** 3


# ---------------------------------------------------------------------------
# Argument bytes per device, equal to the JAX package's specs'
# ---------------------------------------------------------------------------

_JAX_PARAMS: dict = {}


def _jax_params(arch, cfg):
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jax.eval_shape(lambda: JLM.init(jax.random.PRNGKey(0), cfg))
    return _JAX_PARAMS[arch]


def _jax_bytes(tree, specs, mesh) -> int:
    """One device's bytes of ``tree`` laid out by the JAX specs ``specs``."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shards = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shards *= mesh.shape[a]
        total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize // shards
    return total


def _jax_argument_bytes(arch, shape, mesh) -> int:
    """The JAX dry-run's ``build_cell`` arguments (l. 56-95), per device."""
    cfg = JR.config_for(arch, shape)
    sp = JSHP.SHAPES[shape]
    rules = JSH.make_rules(mesh, "train" if sp.kind == "train" else "decode",
                           JSH.ShardFlags())
    params = _jax_params(f"{arch}|{shape}", cfg)
    pspecs = JSH.param_specs(params, rules)
    ins = JSHP.input_specs(cfg, shape)
    total = _jax_bytes(params, pspecs, mesh)
    if sp.kind == "train":
        specs = JLM.group_specs(params, cfg)
        _, opt_init = JT.build_train_step(cfg, specs)
        opt = jax.eval_shape(opt_init, params)
        gm = jax.eval_shape(lambda: JT.init_group_masks(specs))
        total += _jax_bytes(opt.mu, pspecs, mesh) + _jax_bytes(opt.nu, pspecs, mesh)
        total += 4 + _jax_bytes(gm, jax.tree.map(lambda _: JP(), gm), mesh)
        return total + _jax_bytes(ins["batch"], JSH.batch_specs(ins["batch"], rules), mesh)
    if sp.kind == "prefill":
        return total + _jax_bytes(ins["batch"], JSH.batch_specs(ins["batch"], rules), mesh)
    return (total + _jax_bytes(ins["caches"], JSH.cache_specs(ins["caches"], rules), mesh)
            + _jax_bytes(ins["token"], JSH.batch_specs(ins["token"], rules), mesh)
            + _jax_bytes(ins["pos"], JSH.batch_specs(ins["pos"], rules), mesh))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_argument_bytes_equal_jax(arch, shape, multi_pod):
    """Every registry cell: the port's ``build_cell`` arguments (meta
    tensors) laid out by its specs on the shape-only mesh take as many
    bytes per device as the JAX dry-run's."""
    mesh = DR.production_mesh(multi_pod)
    assert mesh.shape == JAX_MESHES[multi_pod].shape
    cfg = TR.config_for(arch, shape)
    fn, args, specs, rules = DR.build_cell(cfg, shape, mesh, TSH.ShardFlags())
    assert all(t.is_meta for a in args for t in DR._tensors(a))
    got = sum(DR.per_device_bytes(a, s, mesh) for a, s in zip(args, specs))
    assert got == _jax_argument_bytes(arch, shape, JAX_MESHES[multi_pod])


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

TEST_SHAPES = {"t_train": TSHP.ShapeSpec("t_train", 64, 8, "train"),
               "t_decode": TSHP.ShapeSpec("t_decode", 64, 8, "decode"),
               "t_prefill": TSHP.ShapeSpec("t_prefill", 16, 2, "prefill")}


@pytest.fixture
def test_shapes(monkeypatch):
    for name, sp in TEST_SHAPES.items():
        monkeypatch.setitem(TSHP.SHAPES, name, sp)


def _walk(cfg, shape):
    mesh = DR.ShapeMesh({"data": 2, "model": 4})
    fn, args, _, _ = DR.build_cell(cfg, shape, mesh, TSH.ShardFlags())
    return DR.walk(fn, args, cfg, shape)


@pytest.mark.parametrize("shape", ["t_train", "t_decode"])
@pytest.mark.parametrize("arch,depths", [("mistral-nemo-12b", (1, 2, 4)),
                                         ("gemma2-9b", (2, 4, 8))])
def test_flops_linear_in_depth(test_shapes, arch, depths, shape):
    """The walk counts every layer: at grad_accum 2, bf16, ``remat="full"``
    (the JAX test's cell), flops(4 d) - flops(2 d) = 2 (flops(2 d) - flops(d))
    exactly; the bytes too (each layer's work is the same, and a stacked
    weight's layers are unbound once, so no layer's backward writes a
    gradient of the whole stack)."""
    base = dataclasses.replace(TR.get(arch).smoke, grad_accum=2, dtype="bfloat16",
                               remat="full")
    f = {L: _walk(dataclasses.replace(base, num_layers=L), shape) for L in depths}
    a, b, c = depths
    assert f[c]["flops"] - f[b]["flops"] == 2 * (f[b]["flops"] - f[a]["flops"]) > 0
    assert f[c]["bytes"] - f[b]["bytes"] == 2 * (f[b]["bytes"] - f[a]["bytes"]) > 0


def test_remat_shows_in_the_saved_bytes(test_shapes):
    base = dataclasses.replace(TR.get("mistral-nemo-12b").smoke, grad_accum=2)
    saved = {r: _walk(dataclasses.replace(base, remat=r), "t_train")["saved_bytes"]
             for r in ("none", "dots", "full")}
    assert saved["none"] > saved["dots"] > saved["full"] > 0, saved


def test_slstm_correction_equal_jax():
    """``_slstm_correction`` for every registry cell and the smoke configs
    (the JAX module sets ``XLA_FLAGS`` at import: the environment is put
    back after)."""
    with mock.patch.dict(os.environ):
        from repro.launch import dryrun as JDR
    for arch in ALL_ARCHS:
        for name, sp in JSHP.SHAPES.items():
            for cj, ct in ((JR.config_for(arch, name), TR.config_for(arch, name)),
                           (JR.get(arch).smoke, TR.get(arch).smoke)):
                for kind in ("train", "prefill", "decode"):
                    assert DR._slstm_correction(ct, TSHP.SHAPES[name], kind) == \
                        JDR._slstm_correction(cj, sp, kind)
    assert DR._slstm_correction(TR.get("xlstm-350m").config, TSHP.SHAPES["train_4k"],
                                "train") > 0


@pytest.mark.parametrize("shape", ["t_train", "t_prefill"])
def test_short_slstm_walk_adds_the_recurrence(test_shapes, shape):
    """The sLSTM recurrence walked over ``SLSTM_WALK_TOKENS`` token plus the
    rest added (FLOPs by ``_slstm_correction``, bytes and saved bytes from a
    walk over one token more) against walking every token: the FLOPs exactly;
    the bytes and saved bytes within 1 % (the walk's filler of the tokens
    left out, a copy of the last state, moves bytes of its own)."""
    cfg = dataclasses.replace(TR.get("xlstm-350m").smoke, grad_accum=1)
    mesh = DR.ShapeMesh({"data": 2, "model": 4})
    fn, args, _, _ = DR.build_cell(cfg, shape, mesh, TSH.ShardFlags())
    short = DR.walk(fn, args, cfg, shape)
    full = DR.walk(fn, args, cfg, shape, slstm_tokens=TEST_SHAPES[shape].seq_len)
    assert short["slstm_flops_added"] > 0 and "slstm_flops_added" not in full
    assert short["flops"] == full["flops"]
    for k in ("bytes", "saved_bytes"):
        assert abs(short[k] - full[k]) <= 0.01 * full[k], (k, short, full)


def test_run_cell_and_main_write_what_the_roofline_twin_reads(tmp_path, capsys):
    """One registry cell through ``main`` (xlstm-350m at ``decode_32k``,
    16 x 16): the JSON record the twin reads, the collective term null; a
    second run finds it cached; an unknown arch matches no cell."""
    out = tmp_path / "dry.json"
    argv = ["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(out)]
    assert DR.main(argv) == 0
    assert "1 cells to run" in capsys.readouterr().out
    rec = json.loads(out.read_text())[f"xlstm-350m|decode_32k|16x16|fsdp1tp1sp0"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["collectives_in_schedule"] is None
    assert rec["roofline"]["t_collective_s"] is None
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == mem["argument_bytes"] > 0
    assert rec["fits_hbm"] is True and rec["useful_compute_ratio"] > 0
    assert DR.main(argv) == 0
    assert "0 cells to run" in capsys.readouterr().out
    assert DR.main(["--arch", "nonesuch", "--out", str(tmp_path / "none.json")]) == 0
    assert "0 cells to run" in capsys.readouterr().out


def test_flags_key_equal_jax():
    with mock.patch.dict(os.environ):
        from repro.launch import dryrun as JDR
    for kw in ({}, {"sp": True}, {"fsdp": False}, {"state_shard": True},
               {"moe_manual_tp": True}):
        assert DR.flags_key(TSH.ShardFlags(**kw)) == JDR.flags_key(JSH.ShardFlags(**kw))
    jf = JSH.ShardFlags()
    object.__setattr__(jf, "opt_bf16", True)
    assert DR.flags_key(TSH.ShardFlags(opt_bf16=True)) == JDR.flags_key(jf)


# ---------------------------------------------------------------------------
# The roofline table twin
# ---------------------------------------------------------------------------

def _record(arch, shape, mesh, t_coll):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "roofline": {"t_compute_s": 0.0123, "t_memory_s": 0.456,
                         "t_collective_s": t_coll, "dominant": "memory"},
            "useful_compute_ratio": 0.76, "memory": {"peak_estimate_bytes": 3 * 2 ** 30},
            "fits_hbm": True}


def _results(t_coll):
    return {"a|train_4k|16x16|f": _record("mistral-nemo-12b", "train_4k", "16x16", t_coll),
            "b|decode_32k|16x16|f": _record("zamba2-7b", "decode_32k", "16x16", t_coll),
            "c|long_500k|16x16|f": {"arch": "gemma-7b", "shape": "long_500k",
                                    "mesh": "16x16", "status": "skipped", "reason": "r"},
            "d|prefill_32k|16x16|f": {"arch": "qwen3-32b", "shape": "prefill_32k",
                                      "mesh": "16x16", "status": "error", "error": "E: x"}}


def test_roofline_twin_prints_the_reference_table(tmp_path, capsys):
    """The same records through ``bench_roofline.run`` (a collective time of
    0) and the twin (not modeled): the same lines, but the collective column
    (``n/m``), the ratio's name (model over counted FLOPs, not HLO's), the
    source and the closing word; the same return."""
    ref, port = tmp_path / "ref.json", tmp_path / "port.json"
    ref.write_text(json.dumps(_results(0.0)))
    port.write_text(json.dumps(_results(None)))
    Args = type("Args", (), {})
    a_ref, a_port = Args(), Args()
    a_ref.dryrun_json, a_port.dryrun_json = str(ref), str(port)
    want_ret = bench_roofline.run(a_ref)
    want = capsys.readouterr().out.splitlines()
    got_ret = bench_roofline_torch.run(a_port)
    got = capsys.readouterr().out.splitlines()
    assert got_ret == want_ret == {"rows": 2, "errors": 1}
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.startswith("Roofline table"):
            continue
        w = w.replace("mdl/HLO", "mdl/cnt").replace("compiled cells", "walked cells")
        w = w.replace("      0.0m", "       n/m")
        assert g == w
    missing = Args()
    missing.dryrun_json = str(tmp_path / "absent.json")
    assert bench_roofline_torch.run(missing) == {}
