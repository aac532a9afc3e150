"""``resnet21-uniform39`` keeps the element sparsity that
``resnet21-hapm50`` realizes: 0.394 within 0.005 of HAPM's, seeds 0-2."""
from __future__ import annotations

import pytest
import torch

from hapm_bench import harness, inputs, model
from hapm_bench.counts import conv as counts


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_uniform_sparsity_matches_hapm(seed):
    torch.set_num_threads(2)
    hapm = harness.find_cell("hapm50-infer-b2048").config
    uniform = harness.find_cell("uniform39-infer-b2048").config
    params, _ = inputs.make_weights(hapm["model"], seed, "cpu")
    layers = inputs.conv_layers(hapm["model"])

    def sparsity(config):
        pruned = model.program_pruning(config, params)["params"]
        live = counts.live_counts(layers, counts.weights_of(pruned, layers))
        return 1 - sum(l["live"] for l in live) / sum(l["k"] ** 2 * l["cin"] * l["cout"]
                                                    for l in live)

    realized = sparsity(hapm)
    assert abs(uniform["pruning"]["sparsity"] - realized) < 0.005
    assert abs(sparsity(uniform) - uniform["pruning"]["sparsity"]) < 1e-3
