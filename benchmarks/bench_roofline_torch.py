"""Roofline table from the port's dry-run results (``repro_torch.launch.dryrun``
writes ``dryrun_results_torch.json``), the twin of ``bench_roofline.py``. One
row per (arch × shape × mesh) cell, in the reference table's format.

The port's dry-run walks each cell on meta tensors and does not model
collectives, so ``t_coll`` reads ``n/m`` (not modeled) and ``bound`` is
taken over the compute and memory terms, at one H100's peaks
(``launch/analysis.py``); ``mdl/cnt`` is the model FLOPs over the FLOPs the
walk counted, and ``GiB/dev`` the walk's peak estimate per device.

    PYTHONPATH=src python -m benchmarks.bench_roofline_torch [--dryrun-json FILE]
"""
from __future__ import annotations

import argparse
import json
import os

DEFAULT_JSON = "dryrun_results_torch.json"


def _ms(t) -> str:
    return f"{'n/m':>9}" if t is None else f"{t*1e3:>8.1f}m"


def run(args=None) -> dict:
    path = getattr(args, "dryrun_json", None) if args else None
    path = path or DEFAULT_JSON
    print("=" * 72)
    print(f"Roofline table (source: {path})")
    print("=" * 72)
    if not os.path.exists(path):
        print("no dry-run results yet — run `python -m repro_torch.launch.dryrun` first")
        return {}
    with open(path) as f:
        results = json.load(f)

    rows, errors, skips = [], [], []
    for key, r in sorted(results.items()):
        if r.get("status") == "skipped":
            skips.append((r["arch"], r["shape"], r["mesh"]))
            continue
        if r.get("status") != "ok" or "roofline" not in r:
            if r.get("status") == "error":
                errors.append((key, r.get("error", "")[:80]))
            continue
        rl = r["roofline"]
        rows.append((r["arch"], r["shape"], r["mesh"],
                     rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"],
                     rl["dominant"], r.get("useful_compute_ratio", float("nan")),
                     r["memory"].get("peak_estimate_bytes", 0) / 2 ** 30,
                     r.get("fits_hbm")))

    print(f"\n{'arch':>22} {'shape':>12} {'mesh':>8} {'t_comp':>9} {'t_mem':>9} "
          f"{'t_coll':>9} {'bound':>10} {'mdl/cnt':>8} {'GiB/dev':>8} {'fits':>5}")
    for r in rows:
        print(f"{r[0]:>22} {r[1]:>12} {r[2]:>8} {_ms(r[3])} {_ms(r[4])} "
              f"{_ms(r[5])} {r[6]:>10} {r[7]:>8.3f} {r[8]:>8.2f} {str(r[9]):>5}")
    if skips:
        print(f"\nskipped cells ({len(skips)}): " +
              ", ".join(f"{a}×{s}@{m}" for a, s, m in skips[:12]) +
              (" …" if len(skips) > 12 else ""))
    for key, err in errors:
        print(f"ERROR {key}: {err}")
    print(f"\n{len(rows)} walked cells, {len(skips)} documented skips, "
          f"{len(errors)} errors")
    return {"rows": len(rows), "errors": len(errors)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-json", default=DEFAULT_JSON)
    run(ap.parse_args())
