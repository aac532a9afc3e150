"""The ResNet-50 cell (``r50-hapm50-infer-b128``, runner
``infer_closed_bottleneck``) on the CPU: the reference's HAPM masks equal the
port's on the tiny net, the reference imports neither the port nor JAX, the
dense work is ResNet-50's by hand, the program's readers give a finite
number in a traced tiny run, the reader of ``k2_tap_fill.infer`` gives the
right values on stubbed contexts, and ``mfu.infer``'s count holds on the
bottleneck net."""
from __future__ import annotations

import math
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, ROOT, run_tiny, tiny
from hapm_bench import harness, model
from hapm_bench.counts import conv as counts
from hapm_bench.reference import resnet as ref_basic
from hapm_bench.reference import resnet_bottleneck as ref
from hapm_bench.runners import infer_closed_bottleneck as runner

CELL = "r50-hapm50-infer-b128"
CONFIG = harness.find_cell(CELL).config


def _reader(name: str):
    return harness.load_module(ROOT / "hapm_bench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("seed", (0, 11, 2 ** 40 + 7))
def test_masks_equal_the_port(seed):
    torch.set_num_threads(2)
    config = harness.merge(CONFIG, tiny(CELL)["config"])
    params, _ = runner.make_weights(config["model"], seed, "cpu")
    port = model.program_pruning(config, params)["element_masks"]
    mine = ref.hapm_masks(params, config["model"], config["pruning"])
    assert len(mine) == len(ref.layers(config["model"])) == 9
    for path in mine:
        assert torch.equal(ref_basic.get(port, path), mine[path]), path


def test_the_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path[:0] = [%r]; "
            "import hapm_bench.reference.resnet_bottleneck; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_dense_macs_by_hand():
    layers = ref.layers(CONFIG["model"])
    assert len(layers) == 53
    # (output height, k * k * cin, cout) a stage, written out by hand
    hand = [(112, 147, 64)]
    for width, h, n, cin, s in ((64, 56, 3, 64, 1), (128, 28, 4, 256, 2),
                                (256, 14, 6, 512, 2), (512, 7, 3, 1024, 2)):
        hand += [(h * s, cin, width), (h, 9 * width, width), (h, width, 4 * width),
                 (h, cin, 4 * width)]
        hand += [(h, 4 * width, width), (h, 9 * width, width), (h, width, 4 * width)] * (n - 1)
    assert [(l["ho"], l["k"] ** 2 * l["cin"], l["cout"]) for l in layers] == hand
    dense = sum(counts.macs(dict(l, live=0), live=False) for l in layers)
    assert dense == 4_087_136_256


def test_program_readers_in_a_traced_tiny_run():
    cell = harness.find_cell(CELL)
    res = run_tiny(CELL, trace=True)["result"]
    program = {m["name"] for m in BENCH["per_layer"]
               if m["source"] in ("program_span", "program_counter")}
    names = {m["name"] for m in cell.per_layer} & program
    assert "k2_tap_fill.infer" in names
    for name in names:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert 0 < res["metrics"]["k2_tap_fill.infer"]["value"] < 100


def _stub_recorder(monkeypatch, counters: dict):
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "counter", lambda name: counters.get(name, 0))


def test_k2_tap_fill_reader(monkeypatch):
    from repro_torch.kernels import implicit_conv
    read = _reader("k2_tap_fill.infer").read
    _stub_recorder(monkeypatch, {implicit_conv.K_ROWS: 4000, implicit_conv.TAP_ROWS: 868})
    assert read(SimpleNamespace()) == pytest.approx(21.7)
    _stub_recorder(monkeypatch, {})
    assert read(SimpleNamespace()) is None                 # K2 ran nothing
    monkeypatch.delattr(implicit_conv, "K_ROWS")
    _stub_recorder(monkeypatch, {"kernel.implicit_block_sparse_conv.tap_rows": 5})
    assert read(SimpleNamespace()) is None                 # a program without the counter


def test_mfu_infer_reader_on_the_bottleneck_net():
    """``mfu.infer`` reads the convs from the runner's layer list; only its
    head term (``counts.head_ops``, which takes the head's input size from
    the stage count alone) misses the ImageNet stem's two downsamplings:
    28 x 28 x 512 inputs for 7 x 7 x 2048, 1.43 M operations a frame for
    4.20 M, 0.04 % of the dense net's 8.17 G."""
    read = _reader("mfu.infer").read
    m = CONFIG["model"]
    layers = [dict(l, live=l["k"] ** 2 * l["cin"] * l["cout"]) for l in ref.layers(m)]
    convs = sum(2 * counts.macs(l) for l in layers)
    head = 7 * 7 * 2048 + 2 * 2048 * 1000
    c = SimpleNamespace(summary={"window_us": 2e6}, units=3, batch=4, layers=layers,
                        model=m, peaks={"int8_ops_s": 1e9})
    want = 100.0 * (convs + head) * 12 / (2.0 * 1e9)
    assert counts.head_ops(m) == 28 * 28 * 512 + 2 * 512 * 1000
    assert read(c) == pytest.approx(want, rel=5e-4)
    assert read(SimpleNamespace(summary=None, units=3)) is None
    assert read(SimpleNamespace(**dict(vars(c), units=0))) is None
