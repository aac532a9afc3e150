"""Paper Table I + Fig. 3 on the PyTorch/CUDA port: the twin of
``benchmarks/bench_training.py``. The four training variants (fp32, int8
QAT, int8+uniform-pruning, int8+HAPM) — accuracies and loss curves.

The variants train through ``repro_torch.train.cnn_training.train_all_variants``
(the twin of the reference's ``benchmarks/cnn_training.py``) on ``--device``
(the GPU unless ``--device cpu``), HAPM without ``sparse_training`` as the
reference bench trains it. Beside the reference's keys the result holds each
variant's training seconds (host clock over its epochs, the device
synchronized) and its SGD steps:

    PYTHONPATH=src python -m benchmarks.bench_training_torch [--fast | --paper] [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.core.masks import global_sparsity, tree_flatten_with_path
from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.models import cnn
from repro_torch.train import cnn_training as CT

HAPM_SPARSITY = 0.5     # train_variant's default for the hapm variant
N_CU = 12               # train_all_variants' default


def sizes(fast: bool, paper: bool):
    """(dataset, epochs per variant) of the reference's three protocols."""
    if paper:
        return SyntheticCifar(num_train=50000, num_test=10000), (200, 100, 100, 60)
    if fast:
        return SyntheticCifar(num_train=512, num_test=256), (1, 1, 1, 1)
    return SyntheticCifar(num_train=2048, num_test=512), (6, 3, 4, 4)


def train_tables(ds, epochs, device) -> dict:
    """Table I and Fig. 3 for ``ds`` and ``epochs`` (fp32, int8, uniform,
    hapm) on ``device``."""
    device = cnn.resolve_device(device)
    print(f"dataset: {ds.num_train} train / {ds.num_test} test "
          f"(synthetic CIFAR-10 stand-in; set $CIFAR10_DIR for the real set)")
    print(f"epochs per variant: {epochs} (paper: 200/100/100/60)\n")

    m1, m2, m3, m4 = CT.train_all_variants(ds, epochs, device=device)

    rows = []
    for m, rep, prune in ((m1, "fp32", "-"), (m2, "Q2.5/Q3.4 int8", "-"),
                          (m3, "Q2.5/Q3.4 int8", "uniform 80%"),
                          (m4, "Q2.5/Q3.4 int8", "HAPM 50% groups")):
        sp = global_sparsity(m.masks)
        rows.append((m.name, rep, prune, m.test_accuracy, sp))
    print(f"\n{'model':>8} {'representation':>16} {'pruning':>16} "
          f"{'accuracy':>9} {'sparsity':>9}")
    for r in rows:
        print(f"{r[0]:>8} {r[1]:>16} {r[2]:>16} {r[3]:>9.4f} {r[4]:>9.3f}")

    # paper claims at reduced scale: quantization costs little; HAPM costs a
    # few points more than uniform but stays in range (Table I: 86.65 vs 84.15)
    print("\nloss curves (Fig. 3):")
    for m in (m1, m2, m3, m4):
        curve = " ".join(f"{l:.3f}" for l in m.history)
        print(f"  {m.name:>8}: {curve}")
    print(f"\ntraining on {device}: " + ", ".join(
        f"{m.name} {m.steps} steps {m.seconds:.2f}s" for m in (m1, m2, m3, m4)))

    return {
        "accuracies": {m.name: m.test_accuracy for m in (m1, m2, m3, m4)},
        "sparsities": {m.name: global_sparsity(m.masks) for m in (m3, m4)},
        "models": (m1, m2, m3, m4),
        "dataset": ds,
        "train_seconds": {m.name: m.seconds for m in (m1, m2, m3, m4)},
        "train_steps": {m.name: m.steps for m in (m1, m2, m3, m4)},
    }


def run(args=None) -> dict:
    fast = bool(args and getattr(args, "fast", False))
    paper = bool(args and getattr(args, "paper", False))
    device = cnn.resolve_device(getattr(args, "device", None) or "cuda")
    print("=" * 72)
    print("Table I / Fig. 3 — training the four model variants")
    print("=" * 72)
    ds, epochs = sizes(fast, paper)
    return train_tables(ds, epochs, device)


def mask_checks(models, n_cu: int = N_CU) -> dict:
    """What must hold of a Table I run: every loss finite, the pruned
    variants' weights exactly 0 wherever their masks are 0, and HAPM's
    target count of (n_cu-channel) groups pruned in the hapm variant."""
    m1, m2, m3, m4 = models
    zero = {}
    for m in (m3, m4):
        masks = dict(tree_flatten_with_path(m.masks))
        zero[m.name] = all(bool(torch.all(w[masks[path] == 0] == 0))
                           for path, w in tree_flatten_with_path(m.params)
                           if path in masks)
    specs = dict(tree_flatten_with_path(cnn.conv_group_specs(m4.params, n_cu)))
    total = sum(s.num_groups for s in specs.values())
    pruned = sum(int(torch.sum(specs[path].group_scores(mask) == 0))
                 for path, mask in tree_flatten_with_path(m4.masks))
    return {"losses_finite": all(math.isfinite(l) for m in models for l in m.history),
            "zero_under_mask": zero,
            "hapm_groups_pruned": pruned,
            "hapm_target_groups": int(round(HAPM_SPARSITY * total))}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="minimal sizes (CI)")
    ap.add_argument("--paper", action="store_true", help="full paper protocol")
    ap.add_argument("--device", default="cuda",
                    help="where the port trains (default: the GPU, an error without one)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
