"""The readers of the program's own spans and counters
(``metrics/<name>.py`` with source ``program_span`` or ``program_counter``,
through ``program_spans.py``): on each cell's tiny CPU run a finite number
of at least 0 in a traced run, a unit's dispatch shorter than the traced
window's time a unit, the second of two traced runs in one process read
from its own window alone, and nothing where the program has no recorder
or holds too few units."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from conftest import BENCH, CELLS, ROOT, run_tiny

ROOT_SPAN = {"infer_closed": "serve.request", "train_steps": "sgd.step"}
PROGRAM = [m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")]


def _reader(name: str):
    from hapm_bench import harness
    return harness.load_module(ROOT / "hapm_bench" / "metrics" / f"{name}.py")


def _last_id() -> int:
    from repro_torch import tracing
    return max((s.id for s in tracing.spans()), default=0)


def _roots_since(name: str, after: int) -> list:
    from repro_torch import tracing
    return [s for s in tracing.spans() if s.id == s.root and s.name == name and s.id > after]


@pytest.mark.parametrize("workload", CELLS)
def test_program_readers_in_a_traced_tiny_run(workload):
    from hapm_bench import harness
    cell = harness.find_cell(workload)
    root = ROOT_SPAN[cell.traffic["runner"]]
    before = _last_id()
    res = run_tiny(workload, trace=True)["result"]
    units = len(_roots_since(root, before))
    assert units >= 1
    names = {m["name"] for m in cell.per_layer} & {m["name"] for m in PROGRAM}
    assert names
    for name in names:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    window_ms = res["device"]["window_s"] * 1e3
    for name in names:
        if name.startswith("dispatch_ms."):
            assert res["metrics"][name]["value"] < window_ms / units


def test_a_second_traced_run_reads_its_own_window():
    from hapm_bench import program_spans
    workload = next(w for w in CELLS if w.startswith("hapm50-infer"))
    before = _last_id()
    run_tiny(workload, trace=True)
    first_end = _last_id()
    first = len(_roots_since("serve.request", before))
    res = run_tiny(workload, trace=True)["result"]
    second = len(_roots_since("serve.request", first_end))
    assert first >= 1 and second >= 1
    window = program_spans.window_units("serve.request", second)
    assert [r.id for r, _ in window] == [r.id for r in _roots_since("serve.request", first_end)]
    assert all(s.root == r.id and s.id > first_end for r, below in window for s in below)
    c = SimpleNamespace(units=second)
    for name in ("dispatch_ms.infer", "sync_wait_ms.infer"):
        assert _reader(name).read(c) == res["metrics"][name]["value"]
    assert program_spans.window_units("serve.request", first + second + 10 ** 6) is None


@pytest.mark.parametrize("name", [m["name"] for m in PROGRAM
                                  if m["name"] != "exec_cache_hit_share.infer"])
def test_no_recorder_reads_nothing(name, monkeypatch):
    """A program without the recorder (a tree older than it) gives None,
    not an error."""
    import sys

    import repro_torch
    run_tiny(next(w for w in CELLS if w.startswith("hapm50-infer")), trace=True)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _reader(name).read(SimpleNamespace(units=1)) is None
