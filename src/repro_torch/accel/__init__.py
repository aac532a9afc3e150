"""The paper's FPGA accelerator as an executable model."""
from .config import AcceleratorConfig, BOARDS, ZYBO_70, ZEDBOARD_100, ZEDBOARD_83_144
from .cycle_model import (
    ConvLayerDims,
    NetworkCycles,
    ScheduleCounts,
    dsb_cycles,
    min_cycles,
    network_cycles,
    schedule_counts,
    theoretical_gops,
    writeback_cycles,
)
from .scheduler import conv_schedule_reference, schedule_step_trace
from .simulator import SimulationReport, simulate
