"""The plain reference agrees with the port on a tiny configuration on
the CPU (the prunings' masks, the served logits, the training steps), and
it imports neither the port nor JAX nor the JAX package."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny
from hapm_bench import harness, inputs, model
from hapm_bench.reference import resnet as ref
from hapm_bench.reference import sgd as ref_sgd


def tiny_config(workload):
    return harness.merge(harness.find_cell(workload).config, tiny(workload)["config"])


def conv_paths(config):
    return [p for p, _, _ in ref.layers(config["model"])]


@pytest.mark.parametrize("workload", ("hapm50-infer-b2048", "uniform39-infer-b2048"))
@pytest.mark.parametrize("seed", (0, 11))
def test_masks_equal_the_port(workload, seed):
    torch.set_num_threads(2)
    config = tiny_config(workload)
    params, _ = inputs.make_weights(config["model"], seed, "cpu")
    port = model.program_pruning(config, params)["element_masks"]
    mine = model.reference_masks(config, params)
    for path in conv_paths(config):
        assert torch.equal(ref.get(port, path), mine[path]), path


@pytest.mark.parametrize("workload", ("hapm50-infer-b2048", "uniform39-infer-b2048"))
def test_served_logits_equal_the_port(workload):
    from repro_torch.launch.serve_cnn import CnnServer
    from repro_torch.models import cnn
    torch.set_num_threads(2)
    config = tiny_config(workload)
    params, state = inputs.make_weights(config["model"], 3, "cpu")
    pruned = model.program_pruning(config, params)["params"]
    server = CnnServer(pruned, state, model.resnet_config(config),
                       spec=cnn.ExecSpec(**config["exec_spec"]), buckets=(8,), device="cpu")
    frames, _ = inputs.make_frames(8, config["model"], 3, "pool", "cpu")
    got = server.infer(frames).double()
    want = ref.served_logits(params, state, model.reference_masks(config, params),
                             config["model"], frames)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    low = ref.served_logits(params, state, model.reference_masks(config, params),
                            config["model"], frames, bits=4)
    assert float((low - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_training_steps_equal_the_port():
    from repro_torch.models import cnn
    from repro_torch.train import cnn_training
    from repro_torch.train.optimizer import sgd
    from hapm_bench.runners import train_steps as drv
    torch.set_num_threads(2)
    config = tiny_config("hapm50-train-b2048")
    mix = harness.find_cell("hapm50-train-b2048").traffic
    params, state = inputs.make_weights(config["model"], 5, "cpu")
    pruned = model.program_pruning(config, params)
    cfg = model.resnet_config(config, quantized=True)
    exec_ = cnn.bind_execution(pruned["params"], cfg,
                               spec=cnn.ExecSpec(**config["train_exec_spec"]),
                               group_masks=pruned["group_masks"], device="cpu")
    step = cnn_training.make_sparse_train_step(cfg, exec_)
    opt = sgd(momentum=mix["momentum"], weight_decay=mix["weight_decay"])[0](pruned["params"])
    p, s = pruned["params"], state
    rec = {"p0": p, "losses": [], "batches": []}
    for i in range(3):
        x, y = inputs.make_frames(8, config["model"], 100 + i, "pool", "cpu")
        p, s, opt, loss = step(p, s, opt, pruned["element_masks"], {"x": x, "y": y}, mix["lr"])
        rec["losses"].append(float(loss))
        rec["batches"].append((x, y))
        if i == 0:
            rec["m1"] = opt.momentum
    rec["p_last"] = p
    masks = model.reference_masks(config, params)
    want = ref_sgd.train_steps(params, masks, rec["batches"], config["model"], mix)
    got = {k: drv._flat(rec[k]) for k in ("p0", "m1", "p_last")}
    got["losses"] = rec["losses"]
    got = drv.compare(got, want, mix["weight_decay"], masks)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-4
    assert got["pruned_nonzero"] == 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import hapm_bench.reference.resnet, hapm_bench.reference.sgd, "
            "hapm_bench.reference.prune_hapm, hapm_bench.reference.prune_magnitude; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
