"""The benchmark's general part: it finds a cell of ``BENCHMARK.json`` by
name, and the cell's configuration, traffic mix, correctness limits,
traffic runner and per-layer metric readers by the names in it, each in a
file of its own, runs the cell, and assembles the result line.

Layout (under this folder): ``configs/<config>.json`` (the model, its
pruning and its execution contract), ``traffic/<mix>.json`` (the mix's
parameters; ``runner`` names the code that runs it),
``runners/<runner>.py``, ``pruning/<kind>.py`` (the program's pruning) and
``reference/prune_<kind>.py`` (the reference's), ``limits/<cell>.json``
(the limits that decide ``correct``), ``metrics/<metric>.py`` (one reader
each), ``kernel_names/<group>/*.txt``, ``counts/``, ``peaks.json``.
"""
from __future__ import annotations

import copy
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file of this folder by its path (its name may hold dots
    and dashes)."""
    name = "hapm_bench_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, root: Path = ROOT, overrides: dict = None):
    """Everything a run of ``workload`` needs, found by name: a namespace
    with ``name``, ``chips``, ``config`` (with its name), ``traffic``,
    ``limits``, ``end_to_end`` and ``per_layer`` (the metrics that apply)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(there are: {', '.join(sorted(cells))})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    overrides = overrides or {}
    config = merge(load_json(root / entry["file"]), overrides.get("config"))
    config["name"] = entry["name"]
    traffic = merge(load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                    overrides.get("traffic"))
    traffic["name"] = cell["traffic"]
    return SimpleNamespace(
        name=workload, chips=cell["chips"], config=config, traffic=traffic,
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX, its libraries and the JAX package (compared whole, so the port's
    package, whose name starts with the JAX package's, is not one)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device, root: Path = ROOT, overrides: dict = None,
             control: bool = False) -> dict:
    """One run of a cell: set-up, the measured window, the checks. Returns
    ``{"result": the result line's object, "checks": [(name, value,
    limit)] of the numbers ``limits/<cell>.json`` compares, "numbers": every
    reading of the check, "control": the control's readings when
    ``control``}``."""
    import torch

    cell = find_cell(workload, root, overrides)
    runner = importlib.import_module(f"hapm_bench.runners.{cell.traffic['runner']}")
    peaks = load_json(HERE / "peaks.json")
    ctx = SimpleNamespace(cell=cell, seed=seed, device=torch.device(device),
                          peaks=peaks, root=root)
    run = runner.setup(ctx)
    setup_s = time.monotonic() - t_start
    from .trace import Tracer
    tracer = Tracer(trace, min(seconds, cell.traffic["trace_seconds"]), ctx.device)
    # what set-up left is collected before the window; inside it the
    # collector runs as it would in a deployment
    gc.collect()
    window = runner.window(ctx, run, seconds, tracer)
    tracer.stop(window["units"])
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                   if ctx.device.type == "cuda" else 0)
    metrics = {}
    if trace:
        layer_ctx = runner.layer_inputs(ctx, run, window, tracer)
        for m in cell.per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(layer_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = runner.end_to_end(ctx, run, window)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    runner.release(run)
    del run
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = runner.check(ctx, window)
    checks = [(k, numbers[k], lim["limit"]) for k, lim in cell.limits.items()]
    out = {"checks": checks, "numbers": numbers}
    if control:
        out["control"] = runner.control(ctx, window)
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if ctx.device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device_info}
    if trace and tracer.summary is not None:
        from .trace import breakdown
        device_info["busy_s"] = tracer.summary["busy_us"] / 1e6
        device_info["window_s"] = tracer.summary["window_us"] / 1e6
        result["breakdown"] = breakdown(tracer.summary)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    out["result"] = result
    return out
