"""The readings the correctness limits are set from, at a cell's own size,
in one process: for each seed one run of the program (its compared numbers),
the control (the reference in the precision below the configuration's, put
in the program's place), and each planted fault asked for.

    python hapm_bench/calibrate.py --workload <name> --seeds 1 2 3 \\
        --seconds 2 [--faults half_batch] [--out FILE]

Writes one JSON line per seed and kind to ``--out`` (and to standard
output)."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--no-control", action="store_true",
                    help="read the program alone")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from hapm_bench import harness
    from hapm_bench.faults import FAULTS
    from hapm_bench.run import cache_dirs

    cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in args.seeds:
        t = time.monotonic()
        got = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t,
                               device="cuda:0", control=not args.no_control)
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              "numbers": got["numbers"],
              "metrics": {k: v["value"] for k, v in got["result"]["metrics"].items()},
              "seconds": time.monotonic() - t})
        if "control" in got:
            emit({"workload": args.workload, "seed": seed, "kind": "control",
                  "numbers": got["control"]})
        for name in args.faults:
            with FAULTS[name]():
                got = harness.run_cell(args.workload, seed, args.seconds, False,
                                       t_start=time.monotonic(), device="cuda:0")
            emit({"workload": args.workload, "seed": seed, "kind": name,
                  "numbers": got["numbers"]})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
