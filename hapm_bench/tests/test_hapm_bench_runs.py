"""Whole runs of each cell on the CPU at a tiny size (the kernels' plain
versions): the result line's keys, ``correct`` true on a sound run and
false under each planted fault the cell can have, the control failing a
limit, and no JAX or JAX package loaded."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, run_tiny, runner_of


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run_tiny(workload)
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer_metrics(workload):
    from hapm_bench import harness
    res = run_tiny(workload, trace=True)["result"]
    assert set(res["metrics"]) <= {m["name"] for m in harness.find_cell(workload).per_layer}
    assert "window_s" in res["device"] and "breakdown" in res


@pytest.mark.parametrize("workload,fault",
                         [(w, f) for w in CELLS for f in runner_of(w).FAULTS])
def test_planted_fault_fails(workload, fault):
    from hapm_bench.faults import FAULTS
    with FAULTS[fault]():
        res = run_tiny(workload)["result"]
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", [w for w in CELLS if runner_of(w).CONTROL_ON_CPU])
def test_control_fails_the_limit_on_the_cpu(workload):
    from hapm_bench import harness
    out = run_tiny(workload, control=True)
    limits = harness.find_cell(workload).limits
    assert any(out["control"][name] > lim["limit"] for name, lim in limits.items())


@pytest.mark.gpu
def test_tf32_control_fails_the_limit_on_the_card():
    """The training control needs the card: the CPU has no TF32."""
    import time

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only on the card")
    from hapm_bench import harness
    overrides = {"traffic": {"batch": 64, "pool_frames": 512}}
    out = harness.run_cell("hapm50-train-b2048", 77, 0.5, False, t_start=time.monotonic(),
                           device="cuda:0", overrides=overrides, control=True)
    limits = harness.find_cell("hapm50-train-b2048").limits
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert any(out["control"][name] > lim["limit"] for name, lim in limits.items())


def test_no_jax_loaded_by_a_run():
    """A fresh interpreter runs every cell at its tiny size, traced, and
    holds no JAX and no JAX package afterwards."""
    code = ("import sys; sys.path[:0] = [%r]; "
            "from conftest import CELLS, run_tiny; "
            "[run_tiny(w, trace=True) for w in CELLS]; "
            "from hapm_bench import harness; print(harness.forbidden_loaded())"
            % str(ROOT / "hapm_bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import hapm_bench.harness, hapm_bench.run, hapm_bench.runners.infer_closed, "
            "hapm_bench.runners.train_steps, hapm_bench.calibrate, hapm_bench.faults; "
            "from hapm_bench import harness; print(harness.forbidden_loaded())"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "hapm_bench" / "run.py"),
                          "--workload", "hapm50-infer-b2048", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_result_line_is_json():
    res = run_tiny("hapm50-infer-b2048")["result"]
    assert json.loads(json.dumps(res)) == res
