"""The reader of ``k2_resident_share.infer`` (a ``program_counter`` metric)
on the tiny CPU fixtures: nothing where the program has no resident counter
(a tree older than the resident path), 0 on the CPU, where the plain versions
launch no kernel, and the counters' share where the card's launches were
counted: 100 when every launch took the resident path."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import CELLS, ROOT, run_tiny

INFER = [w for w in CELLS if "-infer-" in w]


def _reader():
    from hapm_bench import harness
    return harness.load_module(ROOT / "hapm_bench" / "metrics" / "k2_resident_share.infer.py")


@pytest.fixture
def counters():
    """The recorder's two K2 counters, cleared before and after a test."""
    from repro_torch import tracing
    from repro_torch.kernels import implicit_conv as IC
    tracing.reset(IC.LAUNCHES, IC.RESIDENT)
    yield tracing, IC
    tracing.reset(IC.LAUNCHES, IC.RESIDENT)


@pytest.mark.parametrize("workload", INFER)
def test_a_tiny_cpu_run_reads_zero(workload, counters):
    res = run_tiny(workload, trace=True)["result"]
    assert res["metrics"]["k2_resident_share.infer"]["value"] == 0.0


def test_every_launch_resident_reads_100(counters):
    tracing, IC = counters
    tracing.count(IC.LAUNCHES, 21)
    tracing.count(IC.RESIDENT, 21)
    assert _reader().read(SimpleNamespace(units=1)) == 100.0
    tracing.count(IC.LAUNCHES, 3)      # three launches on the per-block path
    assert _reader().read(SimpleNamespace(units=1)) == 100.0 * 21 / 24


def test_no_resident_counter_reads_nothing(counters, monkeypatch):
    tracing, IC = counters
    tracing.count(IC.LAUNCHES, 21)
    monkeypatch.delattr(IC, "RESIDENT")
    assert _reader().read(SimpleNamespace(units=1)) is None
