"""Hand-written CUDA kernels (sources under ``repro_torch/csrc``), their
Python wrappers, and a plain PyTorch version of each.

Every wrapper keeps a launch count — a plain integer that grows by one
where the wrapper launches its CUDA kernel and nowhere else — so a run
can show that it really went through the kernels; ``profile_device_us``
gives the device time a call puts on the card, by kernel name.
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


def profile_device_us(fn, reps: int, device) -> Dict[str, float]:
    """{profiler event name: device time in µs} that ``reps`` calls of
    ``fn()`` put on the card. Only device-side events are summed (an
    operator's host-side event repeats its kernels' time). Raises
    RuntimeError where the profiler cannot trace the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + float(getattr(e, "self_device_time_total", 0.0))
    return out
