"""Gate for the port's executed-sparsity benchmark: the twin of
``benchmarks/check_sparse_regression.py`` for ``BENCH_sparse_cnn_torch.json``
(``benchmarks.bench_sparse_cnn_torch``), against the baseline
``benchmarks/sparse_cnn_baseline_torch.json``.

It fails if the 50 %-group-sparsity ratios regress past the baseline
(``GATES``: deterministic ratios exactly, the timing ratios with
``WALL_SLACK`` headroom, the float-error bound with ``ERR_SLACK``), and it
always enforces the reference bench's three wall-clock floors, which the
twin records with a verdict instead of asserting them: implicit ÷
materializing ≥ 1.3, DSB kernel speedup ≥ 1.2, dense-activation ratio ≥
0.95. ``--require-streaming``, ``--require-dsb`` and ``--require-training``
add the reference's absolute contracts on those columns, with the same
constants and messages. Refresh the baseline from a run on the card:

    PYTHONPATH=src python -m benchmarks.check_sparse_regression_torch --update

``--require-training`` also holds the twin's step with every layer bound
to the same two contracts: at 50 % the default trainable bind keeps only
fully pruned layers, so that step is the one that trains live weights
through the kernels. Its gradients are held to 1e-4 of the dense f32 step
(``grad_parity_all_bound_max_err``) and of the dense step in float64
(``grad_all_bound_max_err_vs_f64``); pruned gradients
(``pruned_group_grad_all_bound_max``) must be exactly zero.

``--require-serving`` and ``--require-resilience`` gate the serving bench
twin's JSON (``benchmarks.bench_serving_cnn_torch``; ``--serving``, default
``BENCH_serving_cnn_torch.json``) with the reference's absolute contracts:
steady-state hit rate exactly 1.0 and bind amortization ≥ 5×, and, on the
``chaos`` row, zero wrong answers, at least three fault kinds, every injected
bind failure retried or downgraded, served + shed == submitted, shed rate ≤
0.5 and a warm restart that reproduces the snapshot. ``--require-serving``
also holds the streamed row's amortization to the same 5×, a floor the
reference bench asserts inside its run and the twin only records (both
amortizations are ratios of two host walls).

The constants and the streaming, DSB, training, serving and resilience
checks are a copy of the reference gate's, by choice: the port and its twins
import nothing of the JAX side, so neither depends on the other's files.
``tests/test_torch_bench_sparse_cnn.py`` and
``tests/test_torch_bench_serving_cnn.py`` hold the copy equal to the
reference (the same constants; the same verdicts and lines on the same row).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_JSON = os.path.join(ROOT, "BENCH_sparse_cnn_torch.json")
SERVING_JSON = os.path.join(ROOT, "BENCH_serving_cnn_torch.json")
BASELINE_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "sparse_cnn_baseline_torch.json")
TARGET = 0.5
TOL = 1e-6

# key -> direction: "max" = current must not exceed baseline (ratios where
# smaller is better), "min" = current must not fall below (speedup factors)
GATES = {
    "grid_step_ratio": "max",
    "pergroup_grid_step_ratio": "max",
    "packed_vs_pergroup_step_cut": "min",
    "schedule_step_ratio": "max",
    "hbm_bytes_ratio": "max",
    "adaptive_vs_fixed_b1_util": "min",
    "implicit_vs_materializing_wallclock_speedup": "min",   # timing-based
    "quantized_hbm_ratio_vs_f32": "max",
    "quantized_max_err_vs_f32": "max",
    "streamed_hbm_ratio_vs_f32": "max",
    "dsb_skip_frac": "min",
    "dsb_kernel_speedup": "min",                            # timing-based
}
# timing-based gates may drop to this fraction of baseline before failing
WALL_KEYS = {"implicit_vs_materializing_wallclock_speedup", "dsb_kernel_speedup"}
WALL_SLACK = 0.7
# float-error gates get multiplicative headroom (the f32 reference can
# drift at ulp level across library builds)
ERR_KEYS = {"quantized_max_err_vs_f32"}
ERR_SLACK = 1.5
# the reference bench's wall-clock floors, which the twin only records
WALL_FLOORS = {"implicit_vs_materializing_wallclock_speedup": 1.3,
               "dsb_kernel_speedup": 1.2,
               "dsb_dense_act_ratio": 0.95}
# serving gates: absolute contracts, no baseline file needed
SERVING_HIT_RATE_MIN = 1.0          # every steady-state request a cache hit
SERVING_AMORTIZATION_MIN = 5.0      # cold bind+forward p50 / steady p50 at batch 1
# streaming gates: absolute contracts, no baseline file needed
STREAMED_HBM_RATIO_MAX = 0.28       # acceptance ceiling (contract prices 0.25)
STREAMED_WIRE_ERR_MAX = 0.0         # in-epilogue requantize: bitwise or wrong
# dual-sided sparsity gates: absolute contracts on the 50 % row
DSB_SKIP_FRAC_MIN = 0.3             # ReLU-sparse input: skip >= 30 % of passes
DSB_SPEEDUP_MIN = 1.2               # skip vs non-skip kernel wall (same machine)
DSB_DENSE_ACT_RATIO_MIN = 0.95      # dense activations must not pay for the skip
DSB_EXACT_ERR_MAX = 0.0             # skip-on == skip-off: bitwise or wrong
# resilience gates: absolute contracts over the chaos row, baseline-free
CHAOS_MIN_FAULT_KINDS = 3           # the scenario must actually inject chaos
CHAOS_SHED_RATE_MAX = 0.5           # bounded shedding, never wholesale refusal
# training gates: absolute contracts (baseline-free) + one timing ratio
TRAIN_GRAD_PARITY_MAX = 1e-4        # dense-vs-sparse gradient max |err|
TRAIN_PRUNED_GRAD_MAX = 0.0         # no-resurrection: exactly zero
TRAIN_RATIO_KEY = "train_step_sparse_vs_dense_ratio"
# the model the gated ratios depend on (batch, timing and the machine do not
# move the deterministic ones)
MODEL_KEYS = ("n_cu", "stages", "widths", "image_size")


def _row_at(report: dict, target: float) -> dict:
    for row in report["rows"]:
        if row["target_group_sparsity"] == target:
            return row
    raise SystemExit(f"no row at target_group_sparsity={target} in report")


def check_wall_floors(row: dict) -> list:
    """The reference bench's wall-clock floors on the 50 % row; returns
    failures. A missing column fails too."""
    failures = []
    for key, floor in WALL_FLOORS.items():
        cur = row.get(key)
        bad = cur is None or cur < floor - TOL
        print(f"  {key:>44}: {cur if cur is not None else 'MISSING'} "
              f"(floor {floor}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(f"{key}_floor")
    return failures


def _serving_report(path: str):
    """The serving twin's JSON at ``path``, or None where there is none."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_serving(path: str = SERVING_JSON) -> list:
    """Gate the serving twin's absolute contracts; returns failures. The
    reference's two lines, then the streamed row's amortization floor."""
    rep = _serving_report(path)
    if rep is None:
        return [f"missing {path} (run benchmarks.bench_serving_cnn_torch)"]
    failures = []
    for key, cur, floor in (
            ("steady_hit_rate", rep.get("steady_hit_rate"), SERVING_HIT_RATE_MIN),
            ("bind_amortization_ratio", rep.get("bind_amortization_ratio"),
             SERVING_AMORTIZATION_MIN),
            ("streamed.bind_amortization_ratio",
             (rep.get("streamed") or {}).get("bind_amortization_ratio"),
             SERVING_AMORTIZATION_MIN)):
        bad = cur is None or cur < floor - TOL
        print(f"  {key:>44}: {cur if cur is not None else 'MISSING'} "
              f"(floor {floor}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(key)
    return failures


def check_resilience(path: str = SERVING_JSON) -> list:
    """Gate the chaos row's absolute contracts; returns failures: zero wrong
    answers (each served output bit-exact against a clean server pinned to
    the ladder rung it ran under), every injected bind failure absorbed by a
    retry or a recorded downgrade, every submitted request served or counted
    as shed, at least CHAOS_MIN_FAULT_KINDS fault kinds injected, a bounded
    shed rate and a warm restart that reproduces the snapshot."""
    rep = _serving_report(path)
    if rep is None:
        return [f"missing {path} (run benchmarks.bench_serving_cnn_torch)"]
    chaos = rep.get("chaos")
    if not chaos:
        print("  chaos row: MISSING (run benchmarks.bench_serving_cnn_torch "
              "--chaos) REGRESSED")
        return ["chaos_row_missing"]
    failures = []
    res = chaos.get("resilience", {})
    trace = chaos.get("trace", {})
    injected = chaos.get("faults_injected", {})
    checks = [
        ("chaos_wrong_answers", chaos.get("wrong_answers"), 0,
         "== (bit-exact per rung or it is a wrong answer)"),
        ("chaos_fault_kinds", len(chaos.get("fault_kinds", [])),
         CHAOS_MIN_FAULT_KINDS, ">="),
        ("chaos_bind_faults_resolved",
         injected.get("bind_fail", 0)
         - res.get("bind_retries", 0) - res.get("bind_failures", 0), 0,
         "== (each injected bind failure retried or downgraded)"),
        ("chaos_requests_accounted",
         trace.get("submitted", -1)
         - trace.get("requests", 0) - trace.get("shed", 0), 0,
         "== (served + shed == submitted: nothing hangs)"),
        ("chaos_shed_rate", chaos.get("shed_rate"), CHAOS_SHED_RATE_MAX, "<="),
        ("chaos_snapshot_warm_restart", chaos.get("snapshot_warm_restart"), True, "=="),
    ]
    for key, cur, bound, op in checks:
        if cur is None:
            bad = True
        elif op.startswith("=="):
            bad = cur != bound
        elif op == ">=":
            bad = cur < bound
        else:
            bad = cur > bound + TOL
        print(f"  {key:>44}: {cur if cur is not None else 'MISSING'} "
              f"({op} {bound}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(key)
    return failures


def check_streaming(row: dict) -> list:
    """Gate the 50 %-row int8-streaming columns; returns failures."""
    failures = []
    for key, ceil in (("streamed_hbm_ratio_vs_f32", STREAMED_HBM_RATIO_MAX),
                      ("streamed_max_err_vs_quantized", STREAMED_WIRE_ERR_MAX)):
        cur = row.get(key)
        bad = cur is None or cur > ceil + TOL
        print(f"  {key:>44}: {cur if cur is not None else 'MISSING'} "
              f"(ceiling {ceil}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(key)
    return failures


def check_dsb(row: dict) -> list:
    """Gate the 50 %-row dual-sided-sparsity columns; returns failures.
    A missing column fails too."""
    failures = []
    checks = (
        ("dsb_max_err_vs_noskip", DSB_EXACT_ERR_MAX, "<="),
        ("dsb_skip_frac", DSB_SKIP_FRAC_MIN, ">="),
        ("dsb_kernel_speedup", DSB_SPEEDUP_MIN, ">="),
        ("dsb_dense_act_ratio", DSB_DENSE_ACT_RATIO_MIN, ">="),
    )
    for key, bound, op in checks:
        cur = row.get(key)
        if cur is None:
            bad = True
        elif op == ">=":
            bad = cur < bound - TOL
        else:
            bad = cur > bound + TOL
        print(f"  {key:>44}: {cur if cur is not None else 'MISSING'} "
              f"({op} {bound}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(key)
    return failures


def check_training(row: dict, baseline: dict) -> list:
    """Gate the 50 %-row training columns; returns failures."""
    failures = []
    for key, ceil in (("grad_parity_max_err", TRAIN_GRAD_PARITY_MAX),
                      ("pruned_group_grad_max", TRAIN_PRUNED_GRAD_MAX),
                      ("grad_parity_all_bound_max_err", TRAIN_GRAD_PARITY_MAX),
                      ("grad_all_bound_max_err_vs_f64", TRAIN_GRAD_PARITY_MAX),
                      ("pruned_group_grad_all_bound_max", TRAIN_PRUNED_GRAD_MAX)):
        cur = row.get(key)
        bad = cur is None or cur > ceil + TOL
        print(f"  {key:>44}: {cur if cur is not None else 'MISSING'} "
              f"(ceiling {ceil}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(key)
    cur = row.get(TRAIN_RATIO_KEY)
    base = baseline.get("gates", {}).get(TRAIN_RATIO_KEY)
    if cur is None:
        print(f"  {TRAIN_RATIO_KEY:>44}: MISSING (rerun the bench) REGRESSED")
        failures.append(TRAIN_RATIO_KEY)
    elif base is not None:
        # smaller is better; allow the same timing headroom as WALL_KEYS
        bad = cur > base / WALL_SLACK + TOL
        print(f"  {TRAIN_RATIO_KEY:>44}: {cur:.6f} (baseline {base:.6f}, "
              f"max, slack 1/{WALL_SLACK}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(TRAIN_RATIO_KEY)
    else:
        print(f"  {TRAIN_RATIO_KEY:>44}: {cur:.6f} (no baseline — refresh "
              f"with --update) ok")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default=BENCH_JSON,
                    help="the twin's JSON (default: BENCH_sparse_cnn_torch.json)")
    ap.add_argument("--baseline", default=BASELINE_JSON,
                    help="the baseline JSON (default: "
                         "benchmarks/sparse_cnn_baseline_torch.json)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline from the current bench output")
    ap.add_argument("--serving", default=SERVING_JSON,
                    help="the serving twin's JSON (default: BENCH_serving_cnn_torch.json)")
    ap.add_argument("--require-serving", action="store_true",
                    help="also gate the serving twin's JSON (hit rate, bind "
                         "amortization, streamed bind amortization)")
    ap.add_argument("--require-streaming", action="store_true",
                    help="also hard-floor the bench's int8-streaming "
                         "columns (HBM ratio <= 0.28, wire parity == 0)")
    ap.add_argument("--require-dsb", action="store_true",
                    help="also hard-floor the bench's dual-sided-sparsity "
                         "columns (skip frac >= 0.3, kernel speedup >= 1.2x, "
                         "dense-act ratio >= 0.95, exactness == 0)")
    ap.add_argument("--require-training", action="store_true",
                    help="also gate the bench's training columns (grad "
                         "parity, pruned-group grads, train-step ratio)")
    ap.add_argument("--require-resilience", action="store_true",
                    help="also gate the serving twin's chaos row (zero wrong "
                         "answers, bind faults resolved, bounded shed rate)")
    args = ap.parse_args(argv)

    with open(args.bench) as f:
        report = json.load(f)
    row = _row_at(report, TARGET)

    if args.update:
        gates = {k: row[k] for k in GATES}
        if TRAIN_RATIO_KEY in row:
            gates[TRAIN_RATIO_KEY] = row[TRAIN_RATIO_KEY]
        baseline = {"config": report["config"], "target_group_sparsity": TARGET,
                    "gates": gates}
        with open(args.baseline, "w") as f:
            json.dump(baseline, f, indent=2)
        print(f"wrote {args.baseline}: {baseline['gates']}")
        return 0

    with open(args.baseline) as f:
        baseline = json.load(f)
    model = lambda c: {k: c.get(k) for k in MODEL_KEYS}
    if model(baseline["config"]) != model(report["config"]):
        print(f"bench config changed ({report['config']} vs baseline "
              f"{baseline['config']}) — refresh the baseline with --update",
              file=sys.stderr)
        return 1
    if baseline["config"].get("card") != report["config"].get("card"):
        print(f"note: the bench ran on {report['config'].get('card') or 'the CPU'}, "
              f"the baseline on {baseline['config'].get('card') or 'the CPU'}: "
              "the timing gates compare two machines")

    failures = []
    for key, direction in GATES.items():
        cur, base = row[key], baseline["gates"][key]
        if key in WALL_KEYS:
            assert direction == "min", "wall gates are speedup floors"
            bad = cur < base * WALL_SLACK - TOL
            note = f"baseline {base:.6f}, {direction}, slack {WALL_SLACK}"
        elif key in ERR_KEYS:
            assert direction == "max", "error gates are upper bounds"
            bad = cur > base * ERR_SLACK + TOL
            note = f"baseline {base:.6f}, {direction}, slack {ERR_SLACK}"
        else:
            bad = (cur > base + TOL) if direction == "max" else (cur < base - TOL)
            note = f"baseline {base:.6f}, {direction}"
        print(f"  {key:>44}: {cur:.6f} ({note}) {'REGRESSED' if bad else 'ok'}")
        if bad:
            failures.append(key)
    failures += check_wall_floors(row)
    if args.require_serving:
        failures += check_serving(args.serving)
    if args.require_streaming:
        failures += check_streaming(row)
    if args.require_dsb:
        failures += check_dsb(row)
    if args.require_training:
        failures += check_training(row, baseline)
    if args.require_resilience:
        failures += check_resilience(args.serving)
    if failures:
        print(f"\nexecuted-sparsity regression at {TARGET:.0%} group "
              f"sparsity: {failures}", file=sys.stderr)
        return 1
    print("\nno executed-sparsity regression vs committed baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
