"""Every cell, configuration, traffic mix, limit file, metric reader,
tiny CPU size and kernel-name group of ``BENCHMARK.json`` is found by its
name, and the file keeps to the benchmark's contract on names, keys and
units. The tests read the cells from the file, so a cell, configuration
or mix added later is checked by adding its files alone."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, CELLS, ROOT, TINY, bench_cell, runner_of

WIDTHS = {"widths", "in_channels", "image_size", "num_classes"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert "hapm_bench" in BENCH["paths"] and len(BENCH["paths"]) <= 16
    assert BENCH["command"] == ["python3", "hapm_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_name_their_config_traffic_and_chips():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24 and len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert isinstance(w["chips"], int) and w["chips"] in (1, 4), w["name"]
        assert w["chips"] in runner_of(w["name"]).CHIPS, w["name"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    from hapm_bench import harness
    cell = harness.find_cell(workload)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert (ROOT / "hapm_bench" / "runners" / f"{cell.traffic['runner']}.py").exists()
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_configs_and_traffic_files():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.exists() and c["file"].startswith("hapm_bench/")
        body = json.loads(path.read_text())
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert key in body or key in body["model"], key
            assert key not in WIDTHS and not key.endswith(("_dim", "_rank")), key
        for kind in ("pruning",):
            k = body[kind]["kind"]
            assert (ROOT / "hapm_bench" / "pruning" / f"{k}.py").exists()
            assert (ROOT / "hapm_bench" / "reference" / f"prune_{k}.py").exists()
    for w in BENCH["workloads"]:
        assert (ROOT / "hapm_bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "hapm_bench" / "limits" / f"{w['name']}.json").exists()


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_size_found_by_name(workload):
    cell = bench_cell(workload)
    assert (TINY / "config" / f"{cell['config']}.json").exists()
    assert (TINY / "traffic" / f"{cell['traffic']}.json").exists()


@pytest.mark.parametrize("workload", CELLS)
def test_runner_names_known_faults(workload):
    from hapm_bench.faults import FAULTS
    runner = runner_of(workload)
    assert set(runner.FAULTS) <= set(FAULTS) and isinstance(runner.CONTROL_ON_CPU, bool)


def test_every_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        assert (ROOT / "hapm_bench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)


def test_names_units_and_lengths():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200


def test_kernel_groups_found():
    from hapm_bench.trace import kernel_groups
    groups = kernel_groups(ROOT / "hapm_bench")
    assert groups["conv_int8"] >= {"implicit_conv_kernel_imma"}
    assert groups["train_sparse"] >= {"implicit_conv_kernel", "block_sparse_matmul_mma_kernel",
                                      "grad_weight_stack_kernel", "grad_weight_reduce_kernel"}


@pytest.mark.parametrize("name,base", [
    ("void hapm::implicit_conv_kernel_imma<8>(signed char const*, int)", "implicit_conv_kernel_imma"),
    ("void hapm::implicit_conv_kernel<float, 8>(float const*)", "implicit_conv_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD"),
])
def test_kernel_base_name(name, base):
    from hapm_bench.trace import kernel_base_name
    assert kernel_base_name(name) == base
