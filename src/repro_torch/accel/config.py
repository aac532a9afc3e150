"""Accelerator parameterization (paper §II).

One PE = one DSP48E1 (multiplier + accumulator). A CU-matrix is a
``CU_x × CU_y`` systolic array of PEs; ``N_CU`` matrices run in lock-step on
shared data/kernel/partial-sum buses. ``CU_h = CU_x + CU_y − 1`` data values
stream in per column; each matrix produces ``G_cu`` kernel windows at a time
and has valid output every ``N_valid = 4`` cycles (paper §II-C: "two 3×3
convolutions every 4 clock cycles" for CU = (2,3)).

A copy of the JAX package's module of the same name (pure Python), so
the port imports nothing of ``repro``; ``tests/test_torch_accel.py`` holds
the two equal.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    cu_x: int = 2
    cu_y: int = 3
    n_cu: int = 12
    freq_mhz: float = 100.0
    dsb: bool = True                 # Dynamic Sparsity Bypass synthesized?
    fifo_depth: int = 8              # depth of per-CU data FIFOs (8 or 32 in the paper)
    n_valid: int = 4                 # cycles until a matrix has valid output
    # FIFO-stall model: achieved = theoretical * fifo_depth / (fifo_depth + stall_const)
    # (paper Discussion: idle states in the Controller FSM when buffers are small;
    #  stall_const calibrated against Table II in benchmarks/bench_inference.py)
    stall_const: float = 4.0
    # output-writeback serialization penalty (paper Discussion): cycles per output
    # element written on the final channel pass, 1/words_per_cycle
    writeback_words_per_cycle: float = 2.0

    @property
    def cu_h(self) -> int:
        return self.cu_x + self.cu_y - 1

    @property
    def dsps(self) -> int:
        return self.n_cu * self.cu_x * self.cu_y

    @property
    def fifo_efficiency(self) -> float:
        return self.fifo_depth / (self.fifo_depth + self.stall_const)


# Board configurations measured in the paper (Table II)
ZYBO_70 = AcceleratorConfig(cu_x=2, cu_y=3, n_cu=12, freq_mhz=70.0)
ZEDBOARD_100 = AcceleratorConfig(cu_x=2, cu_y=3, n_cu=12, freq_mhz=100.0)
ZEDBOARD_83_144 = AcceleratorConfig(cu_x=2, cu_y=3, n_cu=24, freq_mhz=83.3)

BOARDS = {
    "zybo_70mhz_72dsp": ZYBO_70,
    "zedboard_100mhz_72dsp": ZEDBOARD_100,
    "zedboard_83mhz_144dsp": ZEDBOARD_83_144,
}
