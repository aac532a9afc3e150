"""What the benchmark draws from ``--seed`` is the same for the same seed
and differs for another: weights, frames, the request order, the training
feed. Seeds past 32 bits and negative ones work."""
from __future__ import annotations

import pytest
import torch

from hapm_bench import harness, inputs

MODEL = harness.find_cell("hapm50-infer-b2048").config["model"]
SEEDS = (0, 7, 2 ** 31 + 5, 3 * 2 ** 40 + 1, -12)


def flat(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += flat(v) if isinstance(v, dict) else [v]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_deterministic(seed):
    a = flat(inputs.make_weights(MODEL, seed, "cpu")[0])
    b = flat(inputs.make_weights(MODEL, seed, "cpu")[0])
    c = flat(inputs.make_weights(MODEL, seed + 1, "cpu")[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_deterministic(seed):
    x1, y1 = inputs.make_frames(64, MODEL, seed, "pool", "cpu")
    x2, y2 = inputs.make_frames(64, MODEL, seed, "pool", "cpu")
    x3, _ = inputs.make_frames(64, MODEL, seed + 1, "pool", "cpu")
    assert torch.equal(x1, x2) and torch.equal(y1, y2) and not torch.equal(x1, x3)
    assert x1.shape == (64, 32, 32, 3) and 0.0 <= float(x1.min()) and float(x1.max()) <= 1.0
    assert int(y1.min()) >= 0 and int(y1.max()) < 10


def test_weight_shapes_match_the_network():
    params, state = inputs.make_weights(MODEL, 0, "cpu")
    layers = inputs.conv_layers(MODEL)
    assert len(layers) == 21
    for layer in layers:
        node = params
        for k in layer["path"]:
            node = node[k]
        assert tuple(node.shape) == (layer["k"], layer["k"], layer["cin"], layer["cout"])
    assert tuple(params["fc"]["w"].shape) == (64, 10)
    assert float(state["bn0"]["var"].min()) == 1.0


def test_subseed_is_stable_and_separates_streams():
    assert inputs.subseed(5, "weights") == inputs.subseed(5, "weights")
    assert inputs.subseed(5, "weights") != inputs.subseed(5, "pool")
    assert 0 <= inputs.subseed(-1, "x") < 2 ** 63


def test_feed_deterministic():
    from hapm_bench.runners.train_steps import Feed
    mix = {"batch": 8, "pool_frames": 32, "crop_pad": 4}
    a, b = Feed({"model": MODEL}, mix, 9, "cpu"), Feed({"model": MODEL}, mix, 9, "cpu")
    for _ in range(6):                    # past an epoch: a new permutation
        x, y = a.next(), b.next()
        assert torch.equal(x["x"], y["x"]) and torch.equal(x["y"], y["y"])
        assert x["x"].shape == (8, 32, 32, 3)


def test_first_batches_hold_distinct_rows():
    from hapm_bench.runners.train_steps import Feed
    feed = Feed({"model": MODEL}, {"batch": 8, "pool_frames": 32, "crop_pad": 4}, 4, "cpu")
    for _ in range(3):
        feed.next()
    assert feed.pos == 24 and len(set(feed.perm[:24].tolist())) == 24
