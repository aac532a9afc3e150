"""Run one cell of ``BENCHMARK.json`` on this machine's GPU:

    python hapm_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers that decided ``correct`` end
standard error, each beside its limit. Exits with another code than 0, and
prints no result, where there is no CUDA device (or fewer than the cell
asks for), or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build under ``build/repro_torch``)."""
    cache = root / "build" / "hapm_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from hapm_bench import harness

    cell = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hapm_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, device="cuda:0", root=ROOT)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"hapm_bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
