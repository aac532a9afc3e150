"""Algorithm-2 reference: the convolution schedule of the accelerator.

``conv_schedule_reference`` executes the (f_block, g) → (i, j) → parfor-CU
loop nest of paper Algorithm 2 in plain numpy, including the per-CU
SysArray partial-sum semantics. It exists to *prove* the schedule computes
a standard convolution (tests compare it with a library convolution) and to document
exactly which weights are in flight together — the fact HAPM's groups are
built on.

``schedule_step_trace`` enumerates the (f_block, g) schedule steps in
execution order together with the flat group index used by
``core.groups.fpga_conv_groups`` (cin-major? no: the schedule is
f_block-outer, g-inner; group ids are (g, f_block) row-major = g*n_fb+f_block).

A copy of the JAX package's module of the same name (pure Python and numpy), so
the port imports nothing of ``repro``; ``tests/test_torch_accel.py`` holds
the two equal.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .config import AcceleratorConfig


def conv_schedule_reference(
    x: np.ndarray,          # (H, W, Cin) padded input
    k: np.ndarray,          # (kx, ky, Cin, Cout)
    b: np.ndarray,          # (Cout,)
    stride: int,
    accel: AcceleratorConfig,
) -> np.ndarray:
    """Executes Algorithm 2's loop nest. Output (Ho, Wo, Cout), VALID conv."""
    H, W, Cin = x.shape
    kx, ky, _, Cout = k.shape
    Ho = (H - kx) // stride + 1
    Wo = (W - ky) // stride + 1
    out = np.zeros((Ho, Wo, Cout), np.float64)
    t = np.zeros((Ho, Wo, accel.n_cu), np.float64)   # temporal accumulator per CU

    n_fb = -(-Cout // accel.n_cu)
    for fb in range(n_fb):                            # Alg.2 line 4 (f by N_cu)
        f0 = fb * accel.n_cu
        cus = range(min(accel.n_cu, Cout - f0))
        for g in range(Cin):                          # line 5
            for p in range(Ho):                       # lines 6-8 (i over rows)
                i = p * stride
                for q in range(Wo):                   # line 9 (j over cols)
                    j = q * stride
                    cols = x[i:i + kx, j:j + ky, g]
                    for cu in cus:                    # line 13 parfor
                        f_cu = f0 + cu
                        kernel = k[:, :, g, f_cu]
                        presum = b[f_cu] if g == 0 else t[p, q, cu]
                        acc = float(np.sum(cols * kernel)) + presum
                        if g == Cin - 1:              # line 23: last channel
                            out[p, q, f_cu] = acc
                        else:
                            t[p, q, cu] = acc
    return out


def schedule_step_trace(cin: int, cout: int, accel: AcceleratorConfig) -> List[Tuple[int, int, int]]:
    """Execution-ordered (f_block, g, flat_group_id) with flat ids matching
    ``FpgaConvGroupSpec`` ordering (group id = g * n_fblocks + f_block)."""
    n_fb = -(-cout // accel.n_cu)
    steps = []
    for fb in range(n_fb):
        for g in range(cin):
            steps.append((fb, g, g * n_fb + fb))
    return steps
