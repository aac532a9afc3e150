"""Paper Table II + Fig. 6 on the PyTorch/CUDA port: the twin of
``benchmarks/bench_inference.py``. Inference on the accelerator model —
three boards × {int8, uniform-pruned, HAPM} × DSB on/off × FIFO depth 8/32.
Also Fig. 4 (per-layer sparsity layout, uniform vs HAPM).

``repro_torch.accel.simulate`` runs each row with the accuracy forward and
the activation capture on ``--device`` (the GPU unless ``--device cpu``).
Its times and GOP/s (``fpga_ms_per_image``, ``fpga_gops``) are the paper's
cycle model for its FPGA boards, not times on the device. The trained
models come from ``args._trained`` (a ``bench_training_torch`` result) or
from a ``bench_training_torch`` run. Beside the reference's keys the result
holds the printed table (``rows``) and each row's ``SimulationReport``
(``reports``, keyed ``(board, model, dsb, fifo)`` as the reference's):

    PYTHONPATH=src python -m benchmarks.bench_inference_torch [--fast] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.accel import BOARDS, simulate
from repro_torch.core.masks import per_leaf_sparsity
from repro_torch.models import cnn

from benchmarks import bench_training_torch as bench_training

N_FRAMES = 256


def rows_of(m2, m3, m4):
    """(board name, model, DSB, FIFO depth) of every simulated row, in the
    reference's order: HAPM with DSB at FIFO depth 8 and 32, the rest at 8."""
    return [(bname, m, dsb, fifo) for bname in BOARDS for m in (m2, m3, m4)
            for dsb in (True, False)
            for fifo in ((8, 32) if (m is m4 and dsb) else (8,))]


def simulate_row(m, bname, dsb, fifo, imgs, labels, device):
    accel = dataclasses.replace(BOARDS[bname], dsb=dsb, fifo_depth=fifo)
    return simulate(m.params, m.state, m.cfg, accel, imgs, labels, device=device)


def gains(results) -> dict:
    """Fig. 6 speedups over int8 without DSB, HAPM over uniform with DSB (the
    paper's 45 % claim) and FIFO 8 -> 32 on HAPM+DSB, per board, from
    ``{(board, model, dsb, fifo): SimulationReport}``."""
    t = lambda *key: results[key].mean_time_per_image_s
    improvements, claims, fifo = {}, {}, {}
    for bname in BOARDS:
        base = t(bname, "int8", False, 8)
        improvements[bname] = {m: base / t(bname, m, True, 8)
                               for m in ("int8", "uniform", "hapm")}
        tu, th = t(bname, "uniform", True, 8), t(bname, "hapm", True, 8)
        claims[bname] = (tu - th) / tu
        fifo[bname] = (th - t(bname, "hapm", True, 32)) / th
    return {"improvements": improvements, "hapm_vs_uniform": claims, "fifo_8_to_32": fifo}


def run(args=None) -> dict:
    print("=" * 72)
    print("Table II / Fig. 6 / Fig. 4 — accelerator inference")
    print("=" * 72)
    device = cnn.resolve_device(getattr(args, "device", None) or "cuda")
    trained = getattr(args, "_trained", None) if args else None
    if trained is None:
        trained = bench_training.run(args)
    m1, m2, m3, m4 = trained["models"]
    ds = trained["dataset"]
    imgs = ds.test_x[:N_FRAMES]
    labels = ds.test_y[:N_FRAMES]

    results, rows = {}, []
    print(f"\n(fpga ms/img, fpga GOPs: the paper's cycle model for its FPGA boards, "
          f"not times on {device}; acc: the quantized net on {device})")
    hdr = (f"{'board':>24} {'model':>8} {'DSB':>4} {'fifo':>5} {'acc':>7} "
           f"{'fpga ms/img':>12} {'fpga GOPs':>10}")
    print("\n" + hdr)
    for bname, m, dsb, fifo in rows_of(m2, m3, m4):
        rep = simulate_row(m, bname, dsb, fifo, imgs, labels, device)
        results[(bname, m.name, dsb, fifo)] = rep
        rows.append({"board": bname, "model": m.name, "dsb": dsb, "fifo": fifo,
                     "accuracy": rep.accuracy,
                     "fpga_ms_per_image": rep.mean_time_per_image_s * 1e3,
                     "fpga_gops": rep.gops})
        print(f"{bname:>24} {m.name:>8} {str(dsb):>4} {fifo:>5} "
              f"{rep.accuracy:>7.3f} "
              f"{rep.mean_time_per_image_s*1e3:>12.2f} {rep.gops:>10.2f}")
    g = gains(results)

    # Fig. 6: improvement vs the no-DSB int8 baseline per board
    print("\nFig. 6 — speedup over int8/no-DSB baseline (higher is better; cycle model):")
    for bname, row in g["improvements"].items():
        print(f"  {bname:>24}: int8+DSB {row['int8']:.3f}x | uniform+DSB "
              f"{row['uniform']:.3f}x | HAPM+DSB {row['hapm']:.3f}x")

    # headline claim: HAPM ~45% faster than uniform-pruned with DSB
    print("\nHAPM vs uniform (DSB on) — the paper's 45% claim (cycle model):")
    for bname, gain in g["hapm_vs_uniform"].items():
        print(f"  {bname:>24}: {gain*100:.1f}% faster (paper best case: 45%)")

    # FIFO depth effect (Table II last column): 8 -> 32 on HAPM+DSB
    for bname, gain in g["fifo_8_to_32"].items():
        print(f"  fifo 8->32 on {bname}: {100*gain:.1f}% faster (paper: ~8%)")

    print("\nFig. 4 — per-layer weight sparsity (uniform vs HAPM):")
    su = per_leaf_sparsity(m3.masks)
    sh = per_leaf_sparsity(m4.masks)
    for k in sorted(su):
        bar_u = "#" * int(20 * su[k])
        bar_h = "*" * int(20 * sh.get(k, 0.0))
        print(f"  {k:>24} uniform {su[k]:.2f} |{bar_u:<20}|  "
              f"hapm {sh.get(k, 0.0):.2f} |{bar_h:<20}|")
    hapm_layer_sp = list(sh.values())
    print(f"  HAPM layer-sparsity spread: min={min(hapm_layer_sp):.2f} "
          f"max={max(hapm_layer_sp):.2f} (paper Fig. 4: some layers almost "
          f"suppressed, others nearly intact)")

    return {"improvements": g["improvements"], "hapm_vs_uniform": g["hapm_vs_uniform"],
            "rows": rows, "reports": results}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="minimal training sizes (CI)")
    ap.add_argument("--paper", action="store_true", help="full paper training protocol")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default: the GPU, an error without one)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
