"""The benchmark's count of needed work: 40.8 M dense and 29.0 M live
multiply-adds a frame for ``resnet21-hapm50`` at seed 0, each layer's
count against a hand count, and the counts independent of any kernel
tiling."""
from __future__ import annotations

import pytest
import torch

from hapm_bench import harness, inputs, model
from hapm_bench.counts import conv as counts

CONFIG = harness.find_cell("hapm50-infer-b2048").config

# (output height, kx * ky * cin, cout) of each conv, written out by hand
HAND = ([(32, 27, 16)] + [(32, 144, 16)] * 6
        + [(16, 144, 32), (16, 288, 32), (16, 16, 32)] + [(16, 288, 32)] * 4
        + [(8, 288, 64), (8, 576, 64), (8, 32, 64)] + [(8, 576, 64)] * 4)


@pytest.fixture(scope="module")
def hapm_layers():
    torch.set_num_threads(2)
    params, _ = inputs.make_weights(CONFIG["model"], 0, "cpu")
    pruned = model.program_pruning(CONFIG, params)["params"]
    layers = inputs.conv_layers(CONFIG["model"])
    return counts.live_counts(layers, counts.weights_of(pruned, layers)), pruned


def test_dense_macs_by_hand(hapm_layers):
    live, _ = hapm_layers
    assert [(l["ho"], l["k"] ** 2 * l["cin"], l["cout"]) for l in live] == HAND
    dense = [counts.macs(l, live=False) for l in live]
    assert dense == [ho * ho * k * c for ho, k, c in HAND]
    assert sum(dense) == 40_812_544


def test_live_macs_at_seed_0(hapm_layers):
    live, pruned = hapm_layers
    for layer in live:
        node = pruned
        for k in layer["path"]:
            node = node[k]
        hand = int((node != 0).sum()) * layer["ho"] ** 2
        assert counts.macs(layer) == hand
    total = sum(counts.macs(l) for l in live)
    assert abs(total / 1e6 - 29.0) < 0.05, total


def test_served_launch_bytes_and_ops():
    layer = {"h": 32, "ho": 32, "k": 3, "cin": 16, "cout": 16, "live": 1000, "live_cin": 10}
    got = counts.served_launch(layer, 4)
    assert got["ops"] == 2 * 4 * 32 * 32 * 1000
    assert got["bytes"] == 4 * 32 * 32 * 10 + 1000 + 4 * 32 * 32 * 16 + 3 * 4 * 16
    first, later = (counts.train_launches(layer, 4, first=f) for f in (True, False))
    assert len(first) == 2 and len(later) == 3
    assert counts.bound_s({"ops": 10, "bytes": 4}, 5.0, 1.0) == 4.0


def test_head_ops():
    assert counts.head_ops(CONFIG["model"]) == 8 * 8 * 64 + 2 * 64 * 10
