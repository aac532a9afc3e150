"""Port vs JAX package: the executed-sparsity bench twin
(``benchmarks/bench_sparse_cnn_torch.py``) and its gate script
(``benchmarks/check_sparse_regression_torch.py``).

One level of the twin runs on the CPU (plain PyTorch versions of the
kernels) at the reference bench's configuration and target 0.5. The JAX
side makes the model as the reference bench does (``init(PRNGKey(0))``,
each conv weight rescaled to std 0.1, one HAPM epoch); its pruned params and
group masks are handed to both sides, so HAPM's global sort cannot break a
tie differently. Every accounting column of the twin's row must then
**equal** JAX's live calls on the same masks (``bind_execution`` /
``step_counts`` / ``schedule_step_counts`` / ``report`` / ``hbm_bytes``,
``simulate``), and the committed reference row; the int8, streamed and
skip parities read exactly 0."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from benchmarks import bench_sparse_cnn_torch as B
from benchmarks import check_sparse_regression as R
from benchmarks import check_sparse_regression_torch as G
from repro.accel import BOARDS as J_BOARDS, simulate as j_simulate
from repro.core import (HAPMConfig, apply_masks, hapm_element_masks,
                        hapm_epoch_update, hapm_init)
from repro.models import cnn as JC
from repro_torch.models import cnn as TC

ROOT = pathlib.Path(__file__).resolve().parent.parent
TARGET, BATCH = 0.5, 4


def _jax_row(pruned, state, specs, gm, cfg) -> dict:
    """The reference bench's accounting columns at one level, from the JAX
    package's live calls (reference lines 156-218 and 341-363)."""
    bind = lambda **kw: JC.bind_execution(pruned, cfg, spec=JC.ExecSpec(n_cu=B.N_CU, **kw),
                                          specs=specs, group_masks=gm)
    execs = {"implicit": bind(packed=True, implicit=True),
             "materializing": bind(packed=True, implicit=False, bm=128),
             "pergroup": bind(packed=False, implicit=False, bm=128)}
    steps = {k: e.step_counts(cfg, batch=1) for k, e in execs.items()}
    fallbacks = {k: sum(v is None for v in e.table.values()) for k, e in execs.items()}
    live, total = execs["implicit"].schedule_step_counts()
    imp, imp_b = (execs["implicit"].report(cfg, batch=b) for b in (1, BATCH))
    mat = execs["materializing"].report(cfg, batch=1)
    accel = dataclasses.replace(J_BOARDS["zedboard_100mhz_72dsp"], n_cu=B.N_CU)
    return {
        "executed_grid_steps": steps["materializing"][0],
        "dense_grid_steps": steps["materializing"][1],
        "implicit_executed_grid_steps": steps["implicit"][0],
        "implicit_dense_grid_steps": steps["implicit"][1],
        "pergroup_executed_grid_steps": steps["pergroup"][0],
        "pergroup_dense_grid_steps": steps["pergroup"][1],
        "schedule_steps_live": live,
        "schedule_steps_total": total,
        "hbm_bytes_moved_implicit": imp["hbm_bytes_implicit"],
        "hbm_bytes_moved_materialized": imp["hbm_bytes_materialized"],
        "hbm_bytes_moved_quantized": imp["hbm_bytes_implicit_int8"],
        "hbm_bytes_moved_quantized_materialized": imp["hbm_bytes_materialized_int8"],
        "hbm_bytes_moved_streamed": imp["hbm_bytes_streamed_int8"],
        "bm_effective": imp["bm_effective"],
        "padded_mac_utilization": imp_b["padded_mac_utilization"],
        "padded_mac_utilization_b1": imp["padded_mac_utilization"],
        "padded_mac_utilization_b1_fixed_bm": mat["padded_mac_utilization"],
        "pergroup_mac_utilization": execs["pergroup"].mac_utilization(cfg, batch=BATCH),
        "dense_fallback_layers": fallbacks["implicit"],
        "pergroup_dense_fallback_layers": fallbacks["pergroup"],
        "dsb_cycle_ratio": j_simulate(pruned, state, cfg, accel).dsb_cycle_ratio,
    }


def _jax_dsb_counts(pruned, state, specs, gm, cfg) -> dict:
    """The DSB layer's skip counters through the JAX package's kernel (Pallas
    in interpret mode), on the reference bench's ReLU-sparse activation."""
    folded = JC.fold_batchnorm(pruned, state, cfg)
    d_exec = JC.bind_execution(
        folded, cfg, spec=JC.ExecSpec(n_cu=B.N_CU, quantized=True, folded=True,
                                      dense_fallback=2.0, streamed=True, implicit=True,
                                      activation_dsb=True),
        specs=specs, group_masks=gm)
    d_conv = d_exec.table[B.DSB_LAYER]
    cpk = d_conv.layout.implicit_geometry()["cpk"]
    drng = np.random.RandomState(7)
    xa = np.abs(drng.randn(16, 8, 8, cfg.widths[1]).astype(np.float32))
    xa[drng.rand(*xa.shape) < 0.3] = 0.0
    for c0 in range(0, cfg.widths[1], 2 * cpk):
        xa[..., c0:c0 + cpk] = 0.0
    _, stats = d_conv.skip_counts(jnp.asarray(xa), stride=2)
    return {"dsb_skipped_steps": int(stats["skipped_steps"]),
            "dsb_live_steps": int(stats["live_steps"])}


@pytest.fixture(scope="module")
def level():
    """(the twin's row at 0.5 on the CPU, JAX's accounting on the same
    pruned params and group masks, the port's inputs)."""
    jcfg = JC.ResNetConfig(stages=B.CFG.stages, widths=B.CFG.widths,
                           image_size=B.CFG.image_size)
    params, state = JC.init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, l: l / jnp.std(l) * 0.1 if JC.is_conv_weight(p, l) else l, params)
    specs = JC.conv_group_specs(params, B.N_CU)
    hcfg = HAPMConfig(TARGET, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    pruned = apply_masks(params, hapm_element_masks(specs, st))
    want = _jax_row(pruned, state, specs, st.group_masks, jcfg)
    want.update(_jax_dsb_counts(pruned, state, specs, st.group_masks, jcfg))

    cpu = torch.device("cpu")
    tp, ts = TC.params_from_numpy(jax.tree.map(np.asarray, pruned),
                                  jax.tree.map(np.asarray, state), device=cpu)
    tspecs = TC.conv_group_specs(tp, B.N_CU)
    tgm = jax.tree.map(np.asarray, st.group_masks)
    timer = B.Timer(cpu, reps=1)
    x = B.frames(BATCH, cpu)
    row = B.bench_level(tp, ts, tspecs, tgm, TARGET, cpu, x=x, timer=timer)
    return row, want, (tp, ts, tspecs, tgm, x, timer)


ACCOUNTING = ("executed_grid_steps", "dense_grid_steps", "implicit_executed_grid_steps",
              "implicit_dense_grid_steps", "pergroup_executed_grid_steps",
              "pergroup_dense_grid_steps", "schedule_steps_live", "schedule_steps_total",
              "hbm_bytes_moved_implicit", "hbm_bytes_moved_materialized",
              "hbm_bytes_moved_quantized", "hbm_bytes_moved_quantized_materialized",
              "hbm_bytes_moved_streamed", "bm_effective", "padded_mac_utilization",
              "padded_mac_utilization_b1", "padded_mac_utilization_b1_fixed_bm",
              "pergroup_mac_utilization", "dense_fallback_layers",
              "pergroup_dense_fallback_layers", "dsb_cycle_ratio",
              "dsb_skipped_steps", "dsb_live_steps")


@pytest.mark.parametrize("column", ACCOUNTING)
def test_accounting_column_equals_jax(level, column):
    row, want, _ = level
    assert row[column] == want[column]


def test_accounting_matches_committed_reference_row(level):
    """The reference's committed 50 % row (``BENCH_sparse_cnn.json``)."""
    row = level[0]
    ref = json.loads((ROOT / "BENCH_sparse_cnn.json").read_text())
    ref50 = next(r for r in ref["rows"] if r["target_group_sparsity"] == TARGET)
    assert (row["executed_grid_steps"], row["dense_grid_steps"]) == (44, 47)
    assert (row["schedule_steps_live"], row["schedule_steps_total"]) == (899, 1798)
    assert row["hbm_bytes_moved_materialized"] == 9870336
    assert row["dense_fallback_layers"] == 9
    for key in ("executed_grid_steps", "dense_grid_steps", "schedule_steps_live",
                "schedule_steps_total", "hbm_bytes_moved_materialized",
                "hbm_bytes_moved_implicit", "dense_fallback_layers", "bm_effective"):
        assert row[key] == ref50[key], key


@pytest.mark.parametrize("column", ("quantized_max_err_vs_qat",
                                    "streamed_max_err_vs_quantized",
                                    "dsb_max_err_vs_noskip"))
def test_parity_reads_zero_on_cpu(level, column):
    assert level[0][column] == 0.0


def test_device_columns_are_not_measured_on_cpu(level):
    row = level[0]
    dev = [k for k in row if k.startswith("device_")]
    assert dev and all(row[k] is None for k in dev)


def test_training_columns_on_cpu(level):
    """The 50 % training step through the default trainable bind and with
    every layer bound: gradient parity with the dense step and exactly-zero
    pruned gradients. The default bind keeps only the two fully pruned
    projections, so only the all-bound step trains live weights."""
    tp, ts, tspecs, tgm, x, timer = level[2]
    cols = B.train_step_columns(tp, ts, tspecs, tgm, torch.device("cpu"), x=x, timer=timer)
    for tag in ("", "_all_bound"):
        assert cols[f"grad_parity{tag}_max_err"] <= 1e-4
        assert cols[f"grad{tag}_max_err_vs_f64"] <= 1e-4
        assert cols[f"pruned_group_grad{tag}_max"] == 0.0
    assert cols["grad_dense_max_err_vs_f64"] <= 1e-4
    assert cols["train_layers_bound"] == 11 - level[0]["dense_fallback_layers"] == 2
    assert cols["train_live_layers_bound"] == 0
    assert cols["train_layers_bound_all_bound"] == 11
    assert cols["train_live_layers_bound_all_bound"] == 9


# --------------------------------------------------------------------------
# the gate script, on synthetic rows
# --------------------------------------------------------------------------

def _row(**over):
    row = {k: 1.0 for k in G.GATES}
    row.update({"target_group_sparsity": G.TARGET,
                "implicit_vs_materializing_wallclock_speedup": 1.5,
                "dsb_kernel_speedup": 1.4, "dsb_dense_act_ratio": 1.0,
                "streamed_hbm_ratio_vs_f32": 0.25, "streamed_max_err_vs_quantized": 0.0,
                "dsb_skip_frac": 0.5, "dsb_max_err_vs_noskip": 0.0,
                "grad_parity_max_err": 0.0, "pruned_group_grad_max": 0.0,
                "grad_parity_all_bound_max_err": 0.0, "grad_all_bound_max_err_vs_f64": 0.0,
                "pruned_group_grad_all_bound_max": 0.0,
                G.TRAIN_RATIO_KEY: 1.0})
    row.update(over)
    return row


def _gate(tmp_path, row, *flags):
    config = {"n_cu": 12, "stages": [1, 1, 2], "widths": [16, 32, 64], "image_size": 16,
              "batch": 4, "card": "a card"}
    bench, base = tmp_path / "bench.json", tmp_path / "base.json"
    bench.write_text(json.dumps({"config": config, "rows": [_row()]}))
    assert G.main(["--bench", str(bench), "--baseline", str(base), "--update"]) == 0
    bench.write_text(json.dumps({"config": config, "rows": [row]}))
    return G.main(["--bench", str(bench), "--baseline", str(base), "--require-streaming",
                   "--require-dsb", "--require-training", *flags])


def test_gate_passes_a_row_at_baseline(tmp_path):
    assert _gate(tmp_path, _row()) == 0


@pytest.mark.parametrize("over", [
    {"grid_step_ratio": 1.01},                        # deterministic "max" gate
    {"packed_vs_pergroup_step_cut": 0.99},            # deterministic "min" gate
    {"quantized_max_err_vs_f32": 1.6},                # past ERR_SLACK
    {"streamed_max_err_vs_quantized": 1.0},           # --require-streaming
    {"dsb_max_err_vs_noskip": 1.0},                   # --require-dsb
    {"grad_parity_max_err": 2e-4},                    # --require-training
    {"grad_parity_all_bound_max_err": 2e-4},          # --require-training, all bound
    {"grad_all_bound_max_err_vs_f64": 2e-4},
    {"pruned_group_grad_all_bound_max": 1e-3},
    {G.TRAIN_RATIO_KEY: 1.5},                         # past 1 / WALL_SLACK
], ids=lambda o: next(iter(o)))
def test_gate_fails_a_regressed_ratio(tmp_path, over):
    assert _gate(tmp_path, _row(**over)) == 1


def test_gate_reports_a_missed_wall_floor(tmp_path, capsys):
    """The card's implicit ÷ materializing ratio under the reference floor of
    1.3, though within WALL_SLACK of its baseline: reported, exit 1."""
    assert _gate(tmp_path, _row(implicit_vs_materializing_wallclock_speedup=1.2)) == 1
    out = capsys.readouterr()
    assert "implicit_vs_materializing_wallclock_speedup: 1.2 (floor 1.3) REGRESSED" in out.out
    assert "implicit_vs_materializing_wallclock_speedup_floor" in out.err


def test_gate_refuses_another_model(tmp_path):
    config = {"n_cu": 12, "stages": [1, 1, 2], "widths": [16, 32, 64], "image_size": 16}
    bench, base = tmp_path / "bench.json", tmp_path / "base.json"
    bench.write_text(json.dumps({"config": config, "rows": [_row()]}))
    G.main(["--bench", str(bench), "--baseline", str(base), "--update"])
    bench.write_text(json.dumps({"config": {**config, "n_cu": 4}, "rows": [_row()]}))
    assert G.main(["--bench", str(bench), "--baseline", str(base)]) == 1


def test_bench_records_wall_floors_with_a_verdict():
    row = _row(dsb_dense_act_ratio=0.9, device_dsb_dense_act_ratio=1.0)
    floors = B.wall_floors(row)
    assert set(floors) == set(G.WALL_FLOORS)
    assert floors["dsb_dense_act_ratio"] == {"ratio": 0.9, "floor": 0.95,
                                             "device_ratio": 1.0, "verdict": "fail"}
    assert floors["dsb_kernel_speedup"]["verdict"] == "pass"


@pytest.mark.parametrize("name", [
    "TARGET", "TOL", "GATES", "WALL_KEYS", "WALL_SLACK", "ERR_KEYS", "ERR_SLACK",
    "STREAMED_HBM_RATIO_MAX", "STREAMED_WIRE_ERR_MAX", "DSB_SKIP_FRAC_MIN",
    "DSB_SPEEDUP_MIN", "DSB_DENSE_ACT_RATIO_MIN", "DSB_EXACT_ERR_MAX",
    "TRAIN_GRAD_PARITY_MAX", "TRAIN_PRUNED_GRAD_MAX", "TRAIN_RATIO_KEY",
    "SERVING_HIT_RATE_MIN", "SERVING_AMORTIZATION_MIN", "CHAOS_MIN_FAULT_KINDS",
    "CHAOS_SHED_RATE_MAX"])
def test_gate_constants_are_the_reference_gates(name):
    """The twin's copy of the reference gate's constants has not drifted."""
    assert getattr(G, name) == getattr(R, name)


@pytest.mark.parametrize("check", ["check_streaming", "check_dsb"])
@pytest.mark.parametrize("over", [{}, {"streamed_hbm_ratio_vs_f32": 0.3,
                                       "streamed_max_err_vs_quantized": 1.0,
                                       "dsb_skip_frac": 0.2, "dsb_kernel_speedup": 1.1,
                                       "dsb_dense_act_ratio": 0.9,
                                       "dsb_max_err_vs_noskip": 1.0}],
                         ids=["at_floor", "regressed"])
def test_gate_checks_are_the_reference_checks(check, over, capsys):
    """The twin's copied checks give the reference's verdicts and lines."""
    row = _row(**over)
    got = getattr(G, check)(row)
    got_out = capsys.readouterr().out
    want = getattr(R, check)(row)
    assert (got, got_out) == (want, capsys.readouterr().out)


def test_gate_training_check_prints_the_reference_lines(tmp_path, capsys):
    """The twin's training check prints every line of the reference's (and
    adds the all-bound step's) on a regressed row."""
    row = _row(grad_parity_max_err=2e-4, pruned_group_grad_max=1.0,
               **{G.TRAIN_RATIO_KEY: 1.5})
    baseline = {"gates": {G.TRAIN_RATIO_KEY: 1.0}}
    got = G.check_training(row, baseline)
    got_out = capsys.readouterr().out.splitlines()
    want = R.check_training(row, baseline)
    want_out = capsys.readouterr().out.splitlines()
    assert set(want) <= set(got) and set(want_out) <= set(got_out)
