"""Benchmark entry point of the PyTorch/CUDA port, the twin of
``benchmarks/run.py``: ``PYTHONPATH=src python -m benchmarks.run_torch``.

One module per paper table/figure, each run on ``--device`` (the GPU unless
``--device cpu``):
  bench_cycle_model_torch   — §II-E worked example + Fig. 5
  bench_training_torch      — Table I + Fig. 3
  bench_inference_torch     — Table II + Fig. 6 + Fig. 4
  bench_blocksparse_torch   — beyond-paper tile-HAPM block-sparse kernel
  bench_sparse_cnn_torch    — executed group-sparse CNN inference (DSB kernel)
  bench_serving_cnn_torch   — exec-cache serving (latency/hit-rate)
  bench_roofline_torch      — roofline table (reads the dry-run's dryrun_results_torch.json)

``--out`` writes every bench's result (model objects left out) with the
device, the card's name and power limit and each bench's seconds:

    PYTHONPATH=src python -m benchmarks.run_torch --device cpu --fast --only cycle_model blocksparse
    PYTHONPATH=src python -m benchmarks.run_torch --only cycle_model training inference blocksparse --out BENCH_paper_tables_torch.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from benchmarks import (bench_blocksparse_torch, bench_cycle_model_torch,
                        bench_inference_torch, bench_roofline_torch,
                        bench_serving_cnn_torch, bench_sparse_cnn_torch,
                        bench_training_torch)
from repro_torch.models import cnn

ALL = {
    "cycle_model": bench_cycle_model_torch,
    "training": bench_training_torch,
    "inference": bench_inference_torch,
    "blocksparse": bench_blocksparse_torch,
    "sparse_cnn": bench_sparse_cnn_torch,
    "serving_cnn": bench_serving_cnn_torch,
    "roofline": bench_roofline_torch,
}
# keys of a bench's result that hold objects, not numbers: left out of --out
NOT_WRITTEN = ("models", "dataset", "reports")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=list(ALL), default=None)
    ap.add_argument("--fast", action="store_true", help="minimal sizes (CI)")
    ap.add_argument("--paper", action="store_true", help="full paper protocol")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default: the GPU, an error without "
                         "one; 'cpu' runs the kernels' plain PyTorch versions)")
    ap.add_argument("--out", default=None,
                    help="write every bench's result to this JSON file")
    ap.add_argument("--dryrun-json", default=bench_roofline_torch.DEFAULT_JSON,
                    help="the dry-run results the roofline table reads")
    return ap.parse_args(argv)


def run_one(name: str, args, shared: dict) -> dict:
    """Run bench ``name``; training feeds inference, as in the reference."""
    mod = ALL[name]
    if name == "sparse_cnn":
        return mod.run(mod.parse_args(["--device", args.device]
                                      + (["--fast"] if args.fast else [])))
    if name == "serving_cnn":
        return mod.run(mod.parse_args(["--device", args.device]
                                      + (["--smoke"] if args.fast else [])))
    if name == "inference" and "training" in shared:
        args._trained = shared["training"]
    return mod.run(args)


def written(name: str, out: dict) -> dict:
    """What ``--out`` keeps of one bench's result: the training models as
    their loss curves, the dataset as its sizes."""
    kept = {k: v for k, v in out.items() if k not in NOT_WRITTEN}
    if name == "training":
        kept["loss_curves"] = {m.name: m.history for m in out["models"]}
        kept["dataset"] = {"num_train": out["dataset"].num_train,
                           "num_test": out["dataset"].num_test}
    return kept


def write_json(path: str, args, results: dict, seconds: dict, failures: list) -> None:
    device = cnn.resolve_device(args.device)
    doc = {"config": {"fast": args.fast, "paper": args.paper,
                      **bench_sparse_cnn_torch.environment(device)},
           "seconds": seconds, "failures": failures,
           "results": {name: written(name, out) for name, out in results.items()}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {path}")


def main(argv=None):
    args = parse_args(argv)
    device = cnn.resolve_device(args.device)    # no device, no run: nothing falls back
    names = args.only or list(ALL)
    failures, shared, seconds = [], {}, {}
    for name in names:
        t0 = time.time()
        try:
            shared[name] = run_one(name, args, shared)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds[name] = time.time() - t0
            print(f"\n[{name}] OK in {seconds[name]:.1f}s\n")
        except Exception:
            failures.append(name)
            print(f"\n[{name}] FAILED:\n{traceback.format_exc()}\n")
    if args.out:
        write_json(args.out, args, shared, seconds, failures)
    print("=" * 72)
    print(f"benchmarks: {len(names) - len(failures)}/{len(names)} OK"
          + (f"; failed: {failures}" if failures else ""))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
