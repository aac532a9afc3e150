"""Paper Fig. 5 + §II-E worked example on the PyTorch/CUDA port: the twin of
``benchmarks/bench_cycle_model.py``. Theoretical accelerator performance
across (CU_x, N_CU) parameterizations for the chosen CNN, at 100 MHz.

Host arithmetic over the port's cycle model (``repro_torch.accel``); the
network's layer dimensions come from a ``cnn.init`` on ``--device`` (the GPU
unless ``--device cpu``). The numbers are the paper's FPGA cycle model, not
times on the device:

    PYTHONPATH=src python -m benchmarks.bench_cycle_model_torch [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.accel import AcceleratorConfig, ConvLayerDims, min_cycles, theoretical_gops
from repro_torch.models import cnn

CU_X = (1, 2, 3)
N_CU = (4, 8, 12, 16, 24, 32)


def run(args=None) -> dict:
    device = cnn.resolve_device(getattr(args, "device", None) or "cuda")
    print("=" * 72)
    print("Fig. 5 / §II-E — theoretical cycle model")
    print("=" * 72)

    worked = min_cycles(ConvLayerDims(34, 34, 12, 12),
                        AcceleratorConfig(cu_x=2, cu_y=3, n_cu=12))
    print(f"worked example (N_CU=12, CU=(2,3), 32x32+pad, k=3, N_of=N_if=12): "
          f"{worked} cycles (paper: 12288)")
    assert worked == 12288

    cfg = cnn.ResNetConfig()
    params, _ = cnn.init(0, cfg, device=device)
    layers = [d for _, d in cnn.layer_dims(cfg, params)]
    ops = sum(l.ops for l in layers)
    print(f"\nnetwork: 21 conv layers, {ops/1e9:.4f} GOP/image (2 OP/MAC; the "
          f"paper's 0.046 GOP counts ~1 OP/MAC)")

    table = {}
    print(f"\n{'CU_x':>4} {'N_CU':>5} {'DSPs':>5} {'GOPs(theory@100MHz)':>20}")
    for cu_x in CU_X:
        for n_cu in N_CU:
            accel = AcceleratorConfig(cu_x=cu_x, cu_y=3, n_cu=n_cu, freq_mhz=100.0)
            g = theoretical_gops(layers, accel)
            table[(cu_x, n_cu)] = g
            print(f"{cu_x:>4} {n_cu:>5} {accel.dsps:>5} {g:>20.2f}")

    # paper's observation: performance scales with N_CU until ratio ceil()
    # quantization bites; more DSPs never hurt
    for cu_x in CU_X:
        gs = [table[(cu_x, n)] for n in N_CU]
        assert all(b >= a * 0.99 for a, b in zip(gs, gs[1:])), gs
    return {"worked_example_cycles": worked,
            "gops_72dsp_100mhz": table[(2, 12)],
            "table": {f"{cu_x},{n_cu}": g for (cu_x, n_cu), g in table.items()}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where cnn.init runs (default: the GPU, an error without one)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
