"""Beyond-paper on the PyTorch/CUDA port: the twin of
``benchmarks/bench_blocksparse.py``. HAPM tile groups on a plain
(1024 × 1024) weight with (128, 128) tiles, then the port's block-sparse
matmul (K1's f32 instance: tensor-core products in 3×TF32 over only the live
weight tiles, ``csrc/block_sparse_matmul.cu``) on ``--device`` (the GPU
unless ``--device cpu``, where the wrapper runs its plain PyTorch version).
Each level reports the skipped tiles, the kept fraction, the error against
the dense oracle and, on the GPU, the kernel's device time per launch beside
a dense ``torch.matmul`` of the same operands (f32, TF32 off) and the bound:

    PYTHONPATH=src python -m benchmarks.bench_blocksparse_torch [--device cpu]

``bound_ms`` is the larger of the bytes the level must move (x once, the
live weight tiles once, y once) over 3.35 TB/s and its live-tile products
over 67 TFLOP/s (the f32 peak of an H100 SXM).
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from repro_torch.core import HAPMConfig, hapm_element_masks, hapm_epoch_update, hapm_init
from repro_torch.core.groups import tpu_tile_groups
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn
from repro_torch.sparse.block_mask import plan_from_tile_mask, tile_mask_from_weight

K, N, M = 1024, 1024, 256
BLOCK = (128, 128)
TARGETS = (0.25, 0.5, 0.75)
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
REPS, ROUNDS = 50, 5          # launches queued back to back per reading, readings


def levels(device):
    """For each target group sparsity, in the reference's order and from its
    ``RandomState(0)`` draws (the weight first, then each level's x):
    ``(target, x, w, tile_mask, plan, f)`` with ``f`` the bound block-sparse
    matmul and ``x``, ``w`` on ``device``."""
    rng = np.random.RandomState(0)
    w_np = (rng.randn(K, N).astype(np.float32) * rng.rand(K, N)).astype(np.float32)
    w = torch.from_numpy(w_np).to(device)              # heterogeneous magnitudes
    spec = tpu_tile_groups((K, N), BLOCK)
    specs, params = {"w": spec}, {"w": w}
    for target in TARGETS:
        cfg = HAPMConfig(target, 1)
        st = hapm_epoch_update(hapm_init(specs, cfg), specs, params, cfg)
        masks = hapm_element_masks(specs, st)
        wm = (w * masks["w"].to(device)).cpu().numpy()
        tm = tile_mask_from_weight(wm, BLOCK)
        plan = plan_from_tile_mask(tm, BLOCK)
        f = ops.make_block_sparse_matmul(plan, tm)
        x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(device)
        yield target, x, w, tm, plan, f


def device_ms(fn, device) -> float:
    """Device time of one ``fn()`` in ms with the host taken out: a long
    product keeps the GPU busy while the host queues ``REPS`` calls behind
    it, so they run back to back and CUDA events around them time the
    device alone; the median of ``ROUNDS`` readings, after a warmup."""
    busy = torch.randn(8192, 8192, device=device)
    fn()
    torch.cuda.synchronize(device)
    out = []
    for _ in range(ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.mm(busy, busy)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / REPS)
    return statistics.median(out)


def bound(kept_frac: float) -> dict:
    """The least time of one level on an H100: x and y once, the live
    weight tiles once; 2·M·K·N·kept products at the f32 peak."""
    nbytes = 4 * (M * K + kept_frac * K * N + M * N)
    flops = 2 * M * K * N * kept_frac
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def run(args=None) -> dict:
    device = cnn.resolve_device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the dense oracle needs f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    print("=" * 72)
    print(f"tile-HAPM + block-sparse kernel (DSB analogue) on {device}")
    print("=" * 72)
    out = {}
    print(f"\nweight {K}x{N}, tiles {(K // BLOCK[0], N // BLOCK[1])}, block {BLOCK}")
    print(f"{'group sparsity':>15} {'tiles skipped':>14} {'grid-step frac':>15} "
          f"{'max err vs oracle':>18} {'kernel ms':>10} {'matmul ms':>10} {'bound ms':>9}")
    for target, x, w, tm, plan, f in levels(device):
        y = f(x, w)
        y_ref = ref.block_sparse_matmul_ref(x, w, torch.from_numpy(tm), BLOCK)
        err = float(torch.max(torch.abs(y - y_ref)))
        # grid steps executed vs dense: the cycle-model quantity (paper Eq.3
        # analogue — skipped tiles cost neither tensor-core products nor
        # weight loads from device memory)
        frac = plan.cnt.sum() / (plan.tiles[0] * plan.tiles[1])
        row = {"skipped": int(plan.skipped_tiles), "kept_frac": float(frac), "err": err,
               "kernel_device_ms": None, "matmul_device_ms": None, **bound(float(frac))}
        if device.type == "cuda":
            row["kernel_device_ms"] = device_ms(lambda: f(x, w), device)
            row["matmul_device_ms"] = device_ms(lambda: torch.matmul(x, w), device)
        fmt = lambda v: "-" if v is None else f"{v:.5f}"
        print(f"{target:>15.2f} {plan.skipped_tiles:>14} {frac:>15.3f} {err:>18.2e} "
              f"{fmt(row['kernel_device_ms']):>10} {fmt(row['matmul_device_ms']):>10} "
              f"{row['bound_ms']:>9.5f}")
        out[target] = row
        assert err < 1e-3
        assert abs(frac - (1 - target)) < 0.05

    print("\nmodeled per-matmul compute & weight-load saving == kept-tile "
          "fraction (the kernel visits only live tiles; cf. FPGA DSB skipping "
          "whole (f_block, g) schedule steps). kernel / matmul ms: device time "
          "per call, calls queued back to back; bound: max(bytes / 3.35 TB/s, "
          "products / 67 TFLOP/s).")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default: the GPU, an error without one)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
