"""Port vs JAX package: the serving bench twin
(``benchmarks/bench_serving_cnn_torch.py``) and its serving and resilience
gates (``benchmarks/check_sparse_regression_torch.py``).

The twin's ``--smoke`` run goes through the CPU (plain PyTorch versions of
the kernels) on the JAX package's weights: the reference bench's own
``_pruned_model`` makes them (HAPM 0.5 and 0.75), they are converted with
``np.asarray`` and handed to the twin through its ``_pruned_model``. The
cache counters, the mask fingerprints and the per-image HBM accounting must
then **equal** the JAX package's live ``CnnServer`` calls on the same
weights and the same request sequence. The chaos row, whose counters do not
depend on the clock or the weights, must equal the reference's committed
row in ``BENCH_serving_cnn.json``. The reference's ``run()``,
``_merge_chaos()`` and ``main()`` are never called: they write that file."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from benchmarks import bench_serving_cnn as JB
from benchmarks import bench_serving_cnn_torch as B
from benchmarks import check_sparse_regression as R
from benchmarks import check_sparse_regression_torch as G
from repro.launch.serve_cnn import CnnServer as JServer
from repro.models import cnn as JC
from repro_torch.models import cnn as TC

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_CU, BUCKETS, REPS = 4, (1, 4, 8), 6          # the reference's --smoke configuration
SPARSITIES = (0.5, 0.75)
HBM_KEYS = ("hbm_bytes", "hbm_bytes_implicit", "hbm_bytes_materialized",
            "hbm_bytes_implicit_int8", "hbm_bytes_materialized_int8",
            "hbm_bytes_streamed_int8", "hbm_bytes_ratio", "grid_step_ratio",
            "schedule_step_ratio")
CACHE_KEYS = ("hits", "misses", "binds", "invalidated")


def _jax_cfg():
    return JC.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)


def _jax_serving(jax_models) -> dict:
    """The reference run's request sequence on the JAX package's servers,
    untimed (reference lines 301-374 and 385-445): the values the twin's
    accounting columns must equal."""
    cfg, h = _jax_cfg(), 16
    (pruned, state, _), (pruned75, _, _) = (jax_models[s] for s in SPARSITIES)
    rng = np.random.RandomState(0)
    x1 = rng.rand(1, h, h, 3).astype(np.float32)
    srv = JServer(pruned, state, cfg, spec=JC.ExecSpec(n_cu=N_CU), buckets=BUCKETS)
    srv.warmup()
    binds_after_warmup = srv.cache.binds
    srv.cache.hits = srv.cache.misses = 0
    xs = {b: rng.rand(b, h, h, 3).astype(np.float32) for b in BUCKETS}
    for b in BUCKETS:
        for _ in range(REPS):
            np.asarray(srv.infer(xs[b]))
    steady_hit_rate = srv.cache.hit_rate
    for b in BUCKETS:                                # the exactness requests
        np.asarray(srv.infer(xs[b]))
    np.asarray(srv.infer(rng.rand(BUCKETS[-2] + 1, h, h, 3).astype(np.float32)))
    old_fp = srv.mask_fp
    invalidated = srv.update_masks(pruned75)
    np.asarray(srv.infer(x1))
    np.asarray(srv.infer(x1))
    report = srv.report(batch=1)

    sspec = JC.ExecSpec(n_cu=N_CU, quantized=True, folded=True, streamed=True,
                        dense_fallback=2.0)
    srv_s = JServer(pruned, state, cfg, spec=sspec, buckets=BUCKETS)
    srv_s.warmup()
    srv_s.cache.hits = srv_s.cache.misses = 0
    for _ in range(REPS):
        np.asarray(srv_s.infer(x1))
    return {"binds_after_warmup": binds_after_warmup, "steady_hit_rate": steady_hit_rate,
            "streamed_hit_rate": srv_s.cache.hit_rate,
            "hbm_bytes_streamed_int8": srv_s.report(batch=1)["hbm_bytes_streamed_int8"],
            "mask_change": {"invalidated": invalidated, "rebinds": 1,
                            "old_fp": old_fp[:12], "new_fp": srv.mask_fp[:12]},
            "hbm_per_image": {k: report[k] for k in HBM_KEYS},
            "cache": {k: srv.cache.stats()[k] for k in CACHE_KEYS}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the twin's --smoke JSON on the CPU over the JAX package's weights,
    JAX's live values on the same weights)."""
    jax_models = {s: JB._pruned_model(_jax_cfg(), N_CU, sparsity=s) for s in SPARSITIES}
    ported = {}
    for s, (p, st, _) in jax_models.items():
        tp, ts = TC.params_from_numpy(jax.tree.map(np.asarray, p),
                                      jax.tree.map(np.asarray, st), device="cpu")
        ported[s] = (tp, ts, TC.conv_group_specs(tp, N_CU))

    def jax_weights(cfg, n_cu, sparsity, seed=0, device=None):
        assert (n_cu, seed, torch.device(device).type) == (N_CU, 0, "cpu")
        return ported[sparsity]

    out = tmp_path_factory.mktemp("serving") / "s.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B, "_pruned_model", jax_weights)
        report = B.run(B.parse_args(["--device", "cpu", "--smoke", "--out", str(out)]))
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    return report, _jax_serving(jax_models)


@pytest.mark.parametrize("key", ["binds_after_warmup", "steady_hit_rate",
                                 "streamed_hit_rate", "hbm_bytes_streamed_int8"])
def test_serving_counts_equal_jax(runs, key):
    report, want = runs
    got = {**report, "streamed_hit_rate": report["streamed"]["steady_hit_rate"],
           "hbm_bytes_streamed_int8": report["streamed"]["hbm_bytes_streamed_int8"]}
    assert got[key] == want[key]


def test_mask_change_equals_jax(runs):
    report, want = runs
    assert report["mask_change"] == want["mask_change"]
    assert report["mask_change"]["invalidated"] == len(BUCKETS)


@pytest.mark.parametrize("key", HBM_KEYS)
def test_hbm_per_image_equals_jax(runs, key):
    report, want = runs
    assert report["hbm_per_image"][key] == want["hbm_per_image"][key]


@pytest.mark.parametrize("key", CACHE_KEYS)
def test_final_cache_counters_equal_jax(runs, key):
    report, want = runs
    assert report["cache"][key] == want["cache"][key]


def test_config_and_device_fields_on_cpu(runs):
    """The reference's configuration, the cold path's note, and every device
    field ``None`` off CUDA; the amortization floors carry a verdict."""
    report = runs[0]
    cfg = report["config"]
    assert (cfg["n_cu"], cfg["buckets"], cfg["fast"], list(cfg["stages"]),
            list(cfg["widths"]), cfg["image_size"], cfg["sparsity"]) == (
                N_CU, list(BUCKETS), True, [1, 1], [8, 16], 16, 0.5)
    assert "jax.jit" in cfg["cold_path"] and cfg["card"] is None
    assert report["kernel_build_s"] is None and report["bit_identical"] is True
    assert [r["bucket"] for r in report["buckets"]] == list(BUCKETS)
    for row in report["buckets"] + [report["streamed"]]:
        assert row["device_ms"] is row["busy_share"] is row["launches"] is None
    assert report["chaos"]["direct_device_ms"] is None
    floors = report["amortization_floors"]
    assert set(floors) == {"bind_amortization_ratio", "streamed.bind_amortization_ratio"}
    assert floors["bind_amortization_ratio"]["value"] == report["bind_amortization_ratio"]
    for v in floors.values():
        assert v["floor"] == G.SERVING_AMORTIZATION_MIN
        assert v["pass"] == (v["value"] >= v["floor"])


CHAOS_FIELDS = ("fault_kinds", "faults_injected", "resilience", "shed_rate",
                "degrade_log", "answers_checked", "answers_at_recorded_rung",
                "wrong_answers", "snapshot_warm_restart")
TRACE_COUNTS = ("submitted", "requests", "shed", "shed_deadline", "shed_overload")


def _assert_chaos_is_the_reference_row(row):
    ref = json.loads((ROOT / "BENCH_serving_cnn.json").read_text())["chaos"]
    for key in CHAOS_FIELDS:
        assert row[key] == ref[key], key
    for key in TRACE_COUNTS:
        assert row["trace"][key] == ref["trace"][key], key
    for key in ("p50_s", "p99_s"):
        assert abs(row["trace"][key] - ref["trace"][key]) <= 1e-12, key
    assert row["config"] == ref["config"]
    assert (row["trace"]["submitted"], row["trace"]["requests"], row["trace"]["shed_deadline"],
            row["trace"]["shed_overload"], row["answers_checked"],
            row["wrong_answers"]) == (9, 6, 2, 1, 12, 0)


def test_chaos_row_is_the_reference_row(runs):
    """On the JAX package's weights, inside the whole --smoke run."""
    _assert_chaos_is_the_reference_row(runs[0]["chaos"])


def test_chaos_flag_merges_the_reference_row(tmp_path):
    """``--chaos`` on the twin's own weights: the same counters, merged into
    an existing JSON without touching its other keys."""
    out = tmp_path / "s.json"
    out.write_text(json.dumps({"steady_hit_rate": 1.0}))
    B.main(["--chaos", "--device", "cpu", "--smoke", "--out", str(out)])
    merged = json.loads(out.read_text())
    assert merged["steady_hit_rate"] == 1.0
    _assert_chaos_is_the_reference_row(merged["chaos"])


# --------------------------------------------------------------------------
# the serving and resilience gates, on synthetic JSONs
# --------------------------------------------------------------------------

def _serving_json(**over):
    chaos = {"wrong_answers": 0,
             "fault_kinds": ["bind_delay", "bind_fail", "mask_corrupt", "nonfinite"],
             "faults_injected": {"bind_fail": 2, "bind_delay": 1, "nonfinite": 1,
                                 "mask_corrupt": 1},
             "resilience": {"bind_retries": 1, "bind_failures": 1},
             "trace": {"submitted": 9, "requests": 6, "shed": 3},
             "shed_rate": 1 / 3, "snapshot_warm_restart": True}
    rep = {"steady_hit_rate": 1.0, "bind_amortization_ratio": 40.0,
           "streamed": {"bind_amortization_ratio": 30.0}, "chaos": chaos}
    for key, value in over.items():
        if key.startswith("chaos."):
            path = key.split(".")[1:]
            tgt = chaos
            for k in path[:-1]:
                tgt = tgt[k]
            tgt[path[-1]] = value
        elif key == "streamed":
            rep["streamed"]["bind_amortization_ratio"] = value
        else:
            rep[key] = value
    return rep


def _write(tmp_path, rep) -> str:
    path = tmp_path / "serving.json"
    path.write_text(json.dumps(rep))
    return str(path)


def test_serving_gates_pass_a_good_json(tmp_path):
    path = _write(tmp_path, _serving_json())
    assert G.check_serving(path) == [] and G.check_resilience(path) == []


@pytest.mark.parametrize("over,check,failure", [
    ({"steady_hit_rate": 0.9}, "check_serving", "steady_hit_rate"),
    ({"bind_amortization_ratio": 4.0}, "check_serving", "bind_amortization_ratio"),
    ({"streamed": 4.0}, "check_serving", "streamed.bind_amortization_ratio"),
    ({"chaos.wrong_answers": 1}, "check_resilience", "chaos_wrong_answers"),
    ({"chaos": None}, "check_resilience", "chaos_row_missing"),
    ({"chaos.resilience.bind_retries": 0}, "check_resilience", "chaos_bind_faults_resolved"),
    ({"chaos.trace.shed": 2}, "check_resilience", "chaos_requests_accounted"),
], ids=["hit_rate", "amortization", "streamed_amortization", "wrong_answers",
        "chaos_missing", "bind_faults_unresolved", "requests_unaccounted"])
def test_serving_gates_fail_a_regressed_json(tmp_path, over, check, failure):
    path = _write(tmp_path, _serving_json(**over))
    assert getattr(G, check)(path) == [failure]


def test_serving_gates_fail_a_missing_json(tmp_path):
    path = str(tmp_path / "absent.json")
    for check in (G.check_serving, G.check_resilience):
        (failure,) = check(path)
        assert failure.startswith(f"missing {path}")


@pytest.mark.parametrize("check", ["check_serving", "check_resilience"])
@pytest.mark.parametrize("over", [{}, {"steady_hit_rate": 0.9, "bind_amortization_ratio": 4.0,
                                       "chaos.wrong_answers": 1, "chaos.shed_rate": 0.6,
                                       "chaos.trace.shed": 2}],
                         ids=["good", "regressed"])
def test_serving_gate_checks_are_the_reference_checks(tmp_path, monkeypatch, capsys,
                                                      check, over):
    """On one JSON the twin's checks give the reference's verdicts and print
    its lines; the serving check adds the streamed row's floor, which the
    reference asserts inside its bench."""
    path = _write(tmp_path, _serving_json(**over))
    monkeypatch.setattr(R, "SERVING_JSON", path)
    want = getattr(R, check)()
    want_out = capsys.readouterr().out.splitlines()
    got = getattr(G, check)(path)
    got_out = capsys.readouterr().out.splitlines()
    if check == "check_resilience":
        assert (got, got_out) == (want, want_out)
    else:
        assert got[:len(want)] == want and got_out[:len(want_out)] == want_out
        assert got_out[len(want_out):] == [
            f"  {'streamed.bind_amortization_ratio':>44}: 30.0 (floor 5.0) ok"]


def test_serving_flags_gate_without_the_other_flags(tmp_path):
    """``--require-serving`` / ``--require-resilience`` alone, beside a
    sparse bench row at its baseline: the exit code follows the serving
    JSON."""
    row = {**{k: 1.0 for k in G.GATES}, "target_group_sparsity": G.TARGET,
           **{k: 2 * floor for k, floor in G.WALL_FLOORS.items()}}
    bench, base = tmp_path / "bench.json", tmp_path / "base.json"
    bench.write_text(json.dumps({"config": {k: 1 for k in G.MODEL_KEYS}, "rows": [row]}))
    sparse = ["--bench", str(bench), "--baseline", str(base)]
    assert G.main([*sparse, "--update"]) == 0
    flags = [*sparse, "--require-serving", "--require-resilience", "--serving"]
    assert G.main([*flags, _write(tmp_path, _serving_json())]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(_serving_json(**{"chaos.wrong_answers": 1})))
    assert G.main([*flags, str(bad)]) == 1
    assert G.main([*sparse, "--require-serving", "--serving", str(tmp_path / "no.json")]) == 1
