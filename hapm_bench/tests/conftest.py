"""Shared pieces of the benchmark's tests: the repository's root and source
on the path, the cells of ``BENCHMARK.json``, and a run of a cell on the
CPU at a tiny size through the kernels' plain versions. A cell's tiny size
is found by name, in ``tiny/config/<config>.json`` and
``tiny/traffic/<mix>.json``: overrides of its configuration and mix."""
from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])
TINY = Path(__file__).resolve().parent / "tiny"


def bench_cell(workload: str) -> dict:
    return next(w for w in BENCH["workloads"] if w["name"] == workload)


def tiny(workload: str) -> dict:
    cell = bench_cell(workload)
    return {"config": json.loads((TINY / "config" / f"{cell['config']}.json").read_text()),
            "traffic": json.loads((TINY / "traffic" / f"{cell['traffic']}.json").read_text())}


def runner_of(workload: str):
    """The module that runs the cell's traffic mix."""
    from hapm_bench import harness
    return importlib.import_module(
        f"hapm_bench.runners.{harness.find_cell(workload).traffic['runner']}")


def run_tiny(workload: str, seed: int = 2 ** 40 + 3, seconds: float = 0.3,
             trace: bool = False, control: bool = False) -> dict:
    import time

    import torch
    from hapm_bench import harness
    torch.set_num_threads(2)
    return harness.run_cell(workload, seed, seconds, trace, t_start=time.monotonic(),
                            device="cpu", overrides=tiny(workload), control=control)
