"""Hand-written CUDA kernels (sources under ``repro_torch/csrc``), their
Python wrappers, and a plain PyTorch version of each.

Every wrapper keeps a launch count — a plain integer that grows by one
where the wrapper launches its CUDA kernel and nowhere else — so a run
can show that it really went through the kernels.
"""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """{kernel name: CUDA launches since the last reset}."""
    from . import block_sparse_matmul as bsm
    from . import implicit_conv as ic
    from . import int8_matmul as i8
    return {"block_sparse_matmul": bsm.launch_count(),
            "implicit_block_sparse_conv": ic.launch_count(),
            "block_sparse_grad_weight": bsm.grad_weight_launch_count(),
            "int8_matmul": i8.launch_count()}


def reset_launch_counts() -> None:
    from . import block_sparse_matmul as bsm
    from . import implicit_conv as ic
    from . import int8_matmul as i8
    bsm.reset_launch_count()
    bsm.reset_grad_weight_launch_count()
    ic.reset_launch_count()
    i8.reset_launch_count()
