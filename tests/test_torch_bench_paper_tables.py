"""Port vs JAX package: the twins of the paper's table benches
(``benchmarks/bench_{cycle_model,training,inference,blocksparse}_torch.py``)
and of their entry point (``benchmarks/run_torch.py``), on the CPU.

The reference benches run live in the same process (the block-sparse kernel
in Pallas interpret mode). Where a reference bench trains, the test hands
both sides the same untrained models instead: ``cnn.init`` plus one uniform
and one HAPM pruning on the JAX side, the same numpy arrays carried across
with ``cnn.params_from_numpy``. The cycle-model numbers, the skipped tiles,
the inference gains and the Fig. 4 sparsities must be **equal**; the
block-sparse outputs agree within 1e-4 (f32 sums in another order)."""
import argparse
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from benchmarks import bench_blocksparse as RBS
from benchmarks import bench_cycle_model as RCM
from benchmarks import bench_inference as RINF
from benchmarks import bench_training as RTR
from benchmarks import cnn_training as RCT
from benchmarks import (bench_blocksparse_torch as BS, bench_cycle_model_torch as CM,
                        bench_inference_torch as INF, bench_training_torch as TR,
                        run_torch)
from repro.accel import AcceleratorConfig as JAccel, theoretical_gops as j_gops
from repro.core import (HAPMConfig, apply_masks, full_masks, hapm_element_masks,
                        hapm_epoch_update, hapm_init, magnitude_masks)
from repro.core.masks import per_leaf_sparsity as j_per_leaf_sparsity
from repro.data.synthetic import SyntheticCifar as JCifar
from repro.models import cnn as JC
from repro_torch.core.masks import per_leaf_sparsity as t_per_leaf_sparsity
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.data.synthetic import SyntheticCifar as TCifar
from repro_torch.models import cnn as TC
from repro_torch.train.cnn_training import TrainedModel as TModel

CPU = argparse.Namespace(device="cpu")


def _printed(capsys, fn, *a):
    """(result, printed lines) of ``fn(*a)``."""
    capsys.readouterr()
    out = fn(*a)
    return out, capsys.readouterr().out.splitlines()


def _table_lines(lines, header):
    """The lines after the first one that starts with ``header`` (stripped),
    up to the next blank line."""
    start = next(i for i, l in enumerate(lines) if l.strip().startswith(header)) + 1
    end = next((i for i in range(start, len(lines)) if not lines[i].strip()), len(lines))
    return lines[start:end]


# --------------------------------------------------------------------------
# Fig. 5 / §II-E: the cycle model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cycle_model():
    return CM.run(CM.parse_args(["--device", "cpu"]))


def test_cycle_model_values_equal_reference(capsys, cycle_model):
    want, want_lines = _printed(capsys, RCM.run)
    got, got_lines = _printed(capsys, CM.run, CPU)
    assert {k: got[k] for k in want} == want
    assert got["worked_example_cycles"] == 12288
    # the whole printed table, 18 rows, the same characters
    header = "CU_x"
    assert _table_lines(got_lines, header) == _table_lines(want_lines, header)
    assert len(_table_lines(want_lines, header)) == 18
    assert got == cycle_model


def test_cycle_model_table_equals_reference_gops(cycle_model):
    """Every (CU_x, N_CU) cell equals the reference's ``theoretical_gops``
    over the JAX network's layer dimensions, to the last bit."""
    jcfg = JC.ResNetConfig()
    layers = [d for _, d in JC.layer_dims(jcfg, JC.init(jax.random.PRNGKey(0), jcfg)[0])]
    table = cycle_model["table"]
    assert list(table) == [f"{a},{n}" for a in CM.CU_X for n in CM.N_CU]
    for key, g in table.items():
        cu_x, n_cu = map(int, key.split(","))
        assert g == j_gops(layers, JAccel(cu_x=cu_x, cu_y=3, n_cu=n_cu, freq_mhz=100.0))
    assert cycle_model["gops_72dsp_100mhz"] == table["2,12"]


# --------------------------------------------------------------------------
# the tile-HAPM block-sparse bench
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocksparse():
    """(the reference's ``run()``, the tile masks and (x, y) it bound and
    computed per level, the twin's ``run()`` on the CPU, its levels)."""
    seen = []
    make = RBS.ops.make_block_sparse_matmul

    def recording(plan, tm, **kw):
        f = make(plan, tm, **kw)

        def g(x, w):
            y = f(x, w)
            seen.append((np.asarray(tm), np.asarray(x), np.asarray(y)))
            return y
        return g

    mp = pytest.MonkeyPatch()
    mp.setattr(RBS.ops, "make_block_sparse_matmul", recording)
    try:
        want = RBS.run()
    finally:
        mp.undo()
    got = BS.run(CPU)
    return want, seen, got, list(BS.levels(torch.device("cpu")))


@pytest.mark.parametrize("target", BS.TARGETS)
def test_blocksparse_level_equals_reference(blocksparse, target):
    want, seen, got, levels = blocksparse
    i = BS.TARGETS.index(target)
    assert got[target]["skipped"] == want[target]["skipped"] == (16, 32, 48)[i]
    assert got[target]["kept_frac"] == want[target]["kept_frac"]
    assert got[target]["err"] < 1e-3
    tm, x, y = seen[i]
    t, tx, tw, ttm, plan, f = levels[i]
    assert t == target
    np.testing.assert_array_equal(ttm, tm)
    np.testing.assert_array_equal(tx.numpy(), x)
    err = float(np.max(np.abs(f(tx, tw).numpy() - y)))
    assert err <= 1e-4, err


def test_blocksparse_columns_and_bound(blocksparse):
    """The kernel and matmul times are the card's (None on the CPU); the
    bound is reckoned from the shapes: 2·256·1024²·k products at 67 TFLOP/s
    against (1 + 4k + 1) MiB at 3.35 TB/s, so every level is bound by its
    operations."""
    got = blocksparse[2]
    for target, row in got.items():
        k = row["kept_frac"]
        assert row["kernel_device_ms"] is None and row["matmul_device_ms"] is None
        assert row["bound_by"] == "operations"
        assert row["bound_ms"] == pytest.approx(2 * 256 * 1024 ** 2 * k / 67e12 * 1e3)
        assert BS.bound(k)["bound_ms"] >= (1 + 4 * k + 1) * 2 ** 20 / 3.35e12 * 1e3


# --------------------------------------------------------------------------
# Table II / Fig. 6 / Fig. 4 on the same models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The reference's three evaluated variants, untrained: int8 from
    ``cnn.init``, uniform magnitude pruning at 0.8 and HAPM 0.5 (one epoch,
    ``n_cu=12``) of it; as JAX ``TrainedModel``s and as the port's, from the
    same numpy arrays."""
    jcfg = JC.ResNetConfig(quantized=True)
    params, state = JC.init(jax.random.PRNGKey(0), jcfg)
    full = full_masks(params, JC.is_conv_weight)
    uniform = magnitude_masks(params, full, 0.8)
    specs = JC.conv_group_specs(params, 12)
    hcfg = HAPMConfig(0.5, 1)
    hapm = hapm_element_masks(specs, hapm_epoch_update(hapm_init(specs, hcfg), specs,
                                                       params, hcfg))
    jm = [RCT.TrainedModel(name, jcfg, apply_masks(params, m), state, m, [2.3], 0.0)
          for name, m in (("int8", full), ("uniform", uniform), ("hapm", hapm))]
    tcfg = TC.ResNetConfig(quantized=True)
    tm = []
    for m in jm:
        p, s = TC.params_from_numpy(jax.tree.map(np.asarray, m.params),
                                    jax.tree.map(np.asarray, m.state), device="cpu")
        masks = TC.tree_from_numpy(jax.tree.map(np.asarray, m.masks), device="cpu")
        tm.append(TModel(m.name, tcfg, p, s, masks, list(m.history), 0.0))
    return jm, tm


@pytest.fixture(scope="module")
def inference(models):
    jm, tm = models
    jds, tds = JCifar(num_train=8, num_test=16), TCifar(num_train=8, num_test=16)
    np.testing.assert_array_equal(jds.test_x, tds.test_x)
    np.testing.assert_array_equal(jds.test_y, tds.test_y)
    printed = []
    for run, args, ms, ds in ((RINF.run, argparse.Namespace(), jm, jds),
                              (INF.run, argparse.Namespace(device="cpu"), tm, tds)):
        args._trained = {"models": (ms[0], *ms), "dataset": ds}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            printed.append((run(args), buf.getvalue().splitlines()))
    (want, want_lines), (got, got_lines) = printed
    return want, got, want_lines, got_lines


def test_inference_gains_equal_reference(inference):
    want, got = inference[:2]
    assert got["improvements"] == want["improvements"]
    assert got["hapm_vs_uniform"] == want["hapm_vs_uniform"]
    # the paper's ordering: HAPM + DSB is faster than uniform + DSB on every board
    assert all(g > 0 for g in got["hapm_vs_uniform"].values())


def test_inference_rows_are_the_printed_table(inference):
    got = inference[1]
    rows = got["rows"]
    assert len(rows) == 21 == len(got["reports"])
    for r in rows:
        rep = got["reports"][(r["board"], r["model"], r["dsb"], r["fifo"])]
        assert r["fpga_ms_per_image"] == rep.mean_time_per_image_s * 1e3
        assert r["fpga_gops"] == rep.gops and r["accuracy"] == rep.accuracy
    assert [(r["board"], r["model"], r["dsb"], r["fifo"]) for r in rows] == list(got["reports"])


def test_fig4_sparsities_equal_reference(models, inference):
    """Fig. 4's per-layer sparsities: the same keys (the printed rows are
    sorted by them) and the same values, and the same printed rows."""
    jm, tm = models
    for j, t in zip(jm[1:], tm[1:]):
        assert t_per_leaf_sparsity(t.masks) == j_per_leaf_sparsity(j.masks)
    want, got = inference[2:]
    fig4 = lambda lines: _table_lines(lines, "Fig. 4")
    assert len(fig4(want)) == 22 and fig4(got) == fig4(want)


# --------------------------------------------------------------------------
# Table I / Fig. 3: the port alone, one step per variant
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def training():
    return TR.train_tables(TCifar(num_train=128, num_test=16), (1, 1, 1, 1), "cpu")


def test_training_keys_equal_reference(models, training):
    """The reference's ``run()`` with its trainer handing back the untrained
    models gives its keys; the twin adds only each variant's seconds and
    steps."""
    jm = models[0]
    mp = pytest.MonkeyPatch()
    mp.setattr(RCT, "train_all_variants", lambda ds, epochs: (jm[0], *jm))
    try:
        want = RTR.run(argparse.Namespace(fast=True, paper=False))
    finally:
        mp.undo()
    assert set(training) == set(want) | {"train_seconds", "train_steps"}
    for key in ("accuracies", "train_seconds", "train_steps"):
        assert list(training[key]) == ["fp32", "int8", "uniform", "hapm"]
    assert list(training["sparsities"]) == list(want["sparsities"]) == ["uniform", "hapm"]
    assert training["train_steps"] == {k: 1 for k in training["train_steps"]}
    assert all(s > 0 for s in training["train_seconds"].values())


def test_training_masks_hold(training):
    m1, m2, m3, m4 = training["models"]
    checks = TR.mask_checks(training["models"])
    assert checks["losses_finite"]
    assert checks["zero_under_mask"] == {"uniform": True, "hapm": True}
    assert checks["hapm_groups_pruned"] == checks["hapm_target_groups"] > 0
    assert training["sparsities"]["hapm"] > 0


def test_mask_checks_see_a_live_weight_under_a_mask(training):
    """One pruned weight of the hapm variant set to 1: the check says so."""
    m1, m2, m3, m4 = training["models"]
    block, conv, _ = next(path for path, m in tree_flatten_with_path(m4.masks)
                          if bool((m == 0).any()))
    w = m4.params[block][conv]["w"].clone()
    w[m4.masks[block][conv]["w"] == 0] = 1.0
    params = {**m4.params, block: {**m4.params[block], conv: {**m4.params[block][conv],
                                                              "w": w}}}
    broken = dataclasses.replace(m4, params=params)
    assert TR.mask_checks((m1, m2, m3, broken))["zero_under_mask"]["hapm"] is False


# --------------------------------------------------------------------------
# the entry point, and no fallback without a card
# --------------------------------------------------------------------------

def test_run_torch_on_cpu(tmp_path):
    out = tmp_path / "paper.json"
    assert run_torch.main(["--device", "cpu", "--only", "cycle_model", "blocksparse",
                           "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["failures"] == [] and set(doc["seconds"]) == {"cycle_model", "blocksparse"}
    assert doc["config"]["device"] == "cpu" and "card" in doc["config"]
    assert doc["results"]["cycle_model"]["worked_example_cycles"] == 12288
    assert doc["results"]["blocksparse"]["0.5"]["skipped"] == 32


def test_run_torch_leaves_no_object_in_the_json(training):
    written = run_torch.written("training", training)
    assert set(written) == {"accuracies", "sparsities", "train_seconds", "train_steps",
                            "loss_curves", "dataset"}
    json.dumps(written)


@pytest.mark.parametrize("bench", [CM, TR, INF, BS], ids=lambda m: m.__name__.split(".")[-1])
def test_twins_refuse_to_run_without_a_card(monkeypatch, bench):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(bench.parse_args([]))


def test_run_torch_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_torch.main(["--only", "cycle_model"])


# --------------------------------------------------------------------------
# what Table II's comparison of the card with the CPU rests on
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_bn_inverse_std_is_correctly_rounded(scale):
    """BN's 1/sqrt(var + eps) is the correctly rounded f32 root (numpy's)
    followed by a correctly rounded division, so the CPU and the GPU give
    the same bits and the Q3.4 codes after BN cannot flip between them (an
    f32 ``torch.sqrt`` is not correctly rounded)."""
    var = np.random.RandomState(0).rand(200_000).astype(np.float32) * np.float32(scale)
    eps = np.float32(1e-5)
    want = np.float32(1.0) / np.sqrt(var + eps)
    got = TC._inv_std(torch.from_numpy(var), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
