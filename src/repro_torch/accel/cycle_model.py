"""Analytical cycle model — paper Eq. (3)–(9), plus the DSB extension.

Eq. (3):  min_cycles = N_valid · p_x · p_y · N_if · ratio

with the (f_block, g) loop of Algorithm 2 contributing the ``N_if · ratio``
factor. Input sizes *include padding* (paper Alg. 1: "N_ix and N_iy already
take into account the padding"); the worked example (N_CU=12, CU=(2,3),
k=3, s=1, N_of=12, 32×32 'same'-padded to 34×34, N_if=12) gives exactly
12 288 cycles — asserted in tests/test_cycle_model.py.

DSB extension (this work, from the schedule analysis): a schedule step
(f_block, g) is skipped iff its whole weight group is zero, so

    cycles_dsb = N_valid · p_x · p_y · (# non-zero groups)

which is what makes group-aligned (HAPM) zeros valuable and scattered
(uniform-pruning) zeros worthless to the hardware.

A copy of the JAX package's module of the same name (pure Python and numpy), so
the port imports nothing of ``repro``; ``tests/test_torch_accel.py`` holds
the two equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from .config import AcceleratorConfig


@dataclasses.dataclass(frozen=True)
class ConvLayerDims:
    """Dimensions of one conv layer as the accelerator sees it.

    ``n_ix/n_iy`` are the *padded* input sizes. Weight layout (kx, ky, cin, cout).
    """
    n_ix: int
    n_iy: int
    n_if: int
    n_of: int
    kx: int = 3
    ky: int = 3
    sx: int = 1
    sy: int = 1

    @property
    def out_x(self) -> int:
        return (self.n_ix - self.kx) // self.sx + 1

    @property
    def out_y(self) -> int:
        return (self.n_iy - self.ky) // self.sy + 1

    @property
    def macs(self) -> int:
        return self.out_x * self.out_y * self.n_of * self.n_if * self.kx * self.ky

    @property
    def ops(self) -> int:
        return 2 * self.macs


def _k_o(n_k: int, s: int) -> int:
    """Eq. (9): kernel-window overlap; clamped to 1 for numerical stability."""
    return max(abs(n_k - s), 1)


@dataclasses.dataclass(frozen=True)
class ScheduleCounts:
    p_x: int
    p_y: int
    g_cu: int
    g_ky: int
    ratio: int
    n_steps: int          # N_if * ratio  (the (f_block, g) schedule steps)
    cycles_per_step: int  # N_valid * p_x * p_y
    min_cycles: int


def schedule_counts(layer: ConvLayerDims, accel: AcceleratorConfig) -> ScheduleCounts:
    k_ox = _k_o(layer.kx, layer.sx)
    k_oy = _k_o(layer.ky, layer.sy)
    p_x = (layer.n_ix - k_ox) // layer.sx                       # Eq. (4)
    g_cu = max((accel.cu_h - k_oy) // layer.sy, 1)              # Eq. (7)
    g_ky = int(layer.n_iy / k_oy - layer.sy)                    # Eq. (8)
    p_y = math.ceil(g_ky / g_cu)                                # Eq. (5)
    ratio = math.ceil(layer.n_of / accel.n_cu)                  # Eq. (6) (natural number)
    cycles_per_step = accel.n_valid * p_x * p_y
    n_steps = layer.n_if * ratio
    return ScheduleCounts(
        p_x=p_x, p_y=p_y, g_cu=g_cu, g_ky=g_ky, ratio=ratio,
        n_steps=n_steps, cycles_per_step=cycles_per_step,
        min_cycles=cycles_per_step * n_steps,                   # Eq. (3)
    )


def min_cycles(layer: ConvLayerDims, accel: AcceleratorConfig) -> int:
    return schedule_counts(layer, accel).min_cycles


def dsb_cycles(
    layer: ConvLayerDims,
    accel: AcceleratorConfig,
    group_mask: Optional[np.ndarray] = None,
    data_col_nonzero_frac: float = 1.0,
) -> int:
    """Cycles with the Dynamic Sparsity Bypass.

    ``group_mask``: (n_if * ratio,) {0,1} in ``core.fpga_conv_groups``
    ordering — flat group id = ``g * n_fblocks + f_block`` with ``g`` the
    input channel (``groups.py`` / ``scheduler.schedule_step_trace``; note
    the *schedule* executes f_block-outer, g-inner, so execution order and
    id order differ — only the skipped-step count matters here). Zero
    entries are skipped schedule steps. ``data_col_nonzero_frac``: fraction of streamed data columns with
    at least one non-zero value (activation-side bypass; measured by the
    functional simulator, ~1.0 for dense activations).
    """
    sc = schedule_counts(layer, accel)
    if not accel.dsb:
        return sc.min_cycles
    nonzero_steps = sc.n_steps if group_mask is None else int(np.sum(group_mask > 0))
    return int(round(sc.cycles_per_step * nonzero_steps * data_col_nonzero_frac))


def writeback_cycles(layer: ConvLayerDims, accel: AcceleratorConfig) -> int:
    """Paper Discussion: final-pass output stores land in disjoint SRAM
    locations and cannot be packed onto the write bus."""
    n_out = layer.out_x * layer.out_y * layer.n_of
    return int(math.ceil(n_out / accel.writeback_words_per_cycle))


@dataclasses.dataclass(frozen=True)
class NetworkCycles:
    per_layer: tuple
    total_min: int                 # Eq. 3 sum (no DSB, no stalls)
    total_dsb: int                 # with DSB skips
    total_writeback: int
    total_ops: int

    def seconds(self, accel: AcceleratorConfig, with_dsb: bool, with_stalls: bool = True) -> float:
        cycles = (self.total_dsb if (with_dsb and accel.dsb) else self.total_min) + self.total_writeback
        eff = accel.fifo_efficiency if with_stalls else 1.0
        return cycles / eff / (accel.freq_mhz * 1e6)

    def gops(self, accel: AcceleratorConfig, with_dsb: bool, with_stalls: bool = True) -> float:
        return self.total_ops / self.seconds(accel, with_dsb, with_stalls) / 1e9


def network_cycles(
    layers: Sequence[ConvLayerDims],
    accel: AcceleratorConfig,
    group_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    data_col_fracs: Optional[Sequence[float]] = None,
) -> NetworkCycles:
    group_masks = group_masks or [None] * len(layers)
    data_col_fracs = data_col_fracs or [1.0] * len(layers)
    per_layer = []
    for layer, gm, df in zip(layers, group_masks, data_col_fracs):
        mc = min_cycles(layer, accel)
        dc = dsb_cycles(layer, accel, gm, df)
        wb = writeback_cycles(layer, accel)
        per_layer.append((mc, dc, wb, layer.ops))
    return NetworkCycles(
        per_layer=tuple(per_layer),
        total_min=sum(p[0] for p in per_layer),
        total_dsb=sum(p[1] for p in per_layer),
        total_writeback=sum(p[2] for p in per_layer),
        total_ops=sum(p[3] for p in per_layer),
    )


def theoretical_gops(layers: Sequence[ConvLayerDims], accel: AcceleratorConfig) -> float:
    """Fig.-5 quantity: network ops / (Eq.-3 cycles / freq), no stalls/DSB."""
    nc = network_cycles(layers, accel)
    return nc.total_ops / (nc.total_min / (accel.freq_mhz * 1e6)) / 1e9
