"""Hand-written CUDA kernels (sources under ``repro_torch/csrc``), their
Python wrappers, and a plain PyTorch version of each.

Every wrapper keeps a launch count — the port's recorder's counter
``kernel.<name>.launches`` (``repro_torch.tracing``), which grows by one
where the wrapper launches its CUDA kernel and nowhere else — so a run
can show that it really went through the kernels; ``profile_device_records``
gives the device time a call puts on the card and how many records the
profiler kept, by kernel name, and ``record_mismatch`` holds the records of
this package's kernels against their launches; ``queued_device_ms`` times
the same calls with CUDA events where the profiler loses their records.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple


def launch_counts() -> Dict[str, int]:
    """{kernel name: CUDA launches since the last reset}."""
    from .. import tracing
    return {name: tracing.counter(counter) for name, counter in _launch_counters().items()}


def reset_launch_counts() -> None:
    """Zero the four launch counters, and K2's per-path and K-row counters
    (``implicit_conv.RESIDENT``, ``COMPACT``, ``K_ROWS``, ``TAP_ROWS``)
    with its launches."""
    from .. import tracing
    from . import implicit_conv as ic
    tracing.reset(*_launch_counters().values(), ic.RESIDENT, ic.COMPACT, ic.K_ROWS,
                  ic.TAP_ROWS)


def _launch_counters() -> Dict[str, str]:
    """{kernel name: the recorder's launch counter of its wrapper}."""
    from . import block_sparse_matmul as bsm
    from . import implicit_conv as ic
    from . import int8_matmul as i8
    return {"block_sparse_matmul": bsm.LAUNCHES,
            "implicit_block_sparse_conv": ic.LAUNCHES,
            "block_sparse_grad_weight": bsm.GRAD_W_LAUNCHES,
            "int8_matmul": i8.LAUNCHES}


# the device-side name (a substring of the profiler's event name) of the one
# CUDA kernel that each launch counted in ``launch_counts`` runs
LAUNCHED_KERNELS = {
    "block_sparse_matmul": ("block_sparse_matmul_imma_kernel",
                            "block_sparse_matmul_mma_kernel"),
    "implicit_block_sparse_conv": ("implicit_conv_kernel",),
    "block_sparse_grad_weight": ("grad_weight_stack_kernel",),
    "int8_matmul": ("int8_matmul_imma_kernel",),
}


# On an H100 the profiler loses the records at the start of some windows (a
# window's first record far more often than any other; in a long process up
# to the first ~2 ms of device work) and hands a few windows records of the
# window before. So a window opens with a spin kernel of FENCE_LEAD_CYCLES
# (~10 ms) that a loss at its start eats first, and closes with a short one;
# both are left out of the results, and callers hold the records of this
# package's kernels equal to their launches (``record_mismatch``).
FENCE_LEAD_CYCLES = 20_000_000
FENCE_TAIL_CYCLES = 1000
FENCE_KERNEL = "spin_kernel"


class DeviceProfile(NamedTuple):
    """What one profiled window of back-to-back calls put on the card."""
    records: Dict[str, Tuple[float, int]]   # event name: (device µs, records)
    launched: Dict[str, int]                # kernel name: this package's launches
    fences: int                             # fence records kept, of 2


def profile_device_records(fn, reps: int, device) -> DeviceProfile:
    """The device-side events of ``reps`` back-to-back calls of ``fn()``,
    and this package's launches in the same window. One call of ``fn`` runs
    first, in a warm-up step the profiler does not record, and the device is
    idle when the window opens; a fence kernel opens and closes the window
    (see ``FENCE_LEAD_CYCLES``).
    Only device-side kernel and copy events count (an operator's host-side
    event repeats its kernels' time; the profiler's step marker and the
    fences are left out). Raises RuntimeError where the profiler cannot
    trace the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize(device)
        prof.step()
        torch.cuda._sleep(FENCE_LEAD_CYCLES)
        before = launch_counts()
        for _ in range(reps):
            fn()
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        torch.cuda._sleep(FENCE_TAIL_CYCLES)
        torch.cuda.synchronize(device)
    out: Dict[str, Tuple[float, int]] = {}
    fences = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue
        if FENCE_KERNEL in e.key:
            fences += int(e.count)
            continue
        us, n = out.get(e.key, (0.0, 0))
        out[e.key] = (us + float(getattr(e, "self_device_time_total", 0.0)), n + int(e.count))
    return DeviceProfile(out, launched, fences)


def records_by_kernel(records: Dict[str, Tuple[float, int]]) -> Dict[str, int]:
    """{kernel name: how many launches of it a profile recorded}."""
    return {kname: sum(n for key, (_, n) in records.items()
                       if any(name in key for name in names))
            for kname, names in LAUNCHED_KERNELS.items()}


def record_mismatch(launched: Dict[str, int], records: Dict[str, Tuple[float, int]]
                    ) -> Dict[str, Tuple[int, int]]:
    """{kernel name: (records, launches)} for each of this package's kernels
    that a profile recorded another number of times than its wrapper
    launched it in the same window (``launched``, as
    ``profile_device_records`` counts it): the profiler lost records (a time
    summed from the profile reads low) or took in another window's."""
    got = records_by_kernel(records)
    return {k: (got[k], n) for k, n in launched.items() if got[k] != n}


def scaled_device_us(launched: Dict[str, int], records: Dict[str, Tuple[float, int]]
                     ) -> Optional[float]:
    """A window's device time in µs with each of this package's kernels'
    time divided by the records the profile kept of it and multiplied by
    its launches (the time per record over every launch); the other events
    as recorded. ``None`` where a launched kernel has no record at all."""
    got = records_by_kernel(records)
    if any(n and not got[k] for k, n in launched.items()):
        return None
    total = 0.0
    for key, (us, _) in records.items():
        kname = next((k for k, names in LAUNCHED_KERNELS.items()
                      if any(name in key for name in names)), None)
        total += us if kname is None else us * launched[kname] / got[kname]
    return total


def queued_device_ms(fn, calls: int, device, tries: int = 4) -> Optional[float]:
    """Device ms of one ``fn()`` without the profiler: CUDA events around
    ``calls`` back-to-back calls that the host queued behind a spin kernel,
    so the device runs them with no wait on the host (the time between
    them on the device is counted, unlike in a profile's sum). One warm-up
    call first. Where the spin had ended before the last call was queued,
    the spin is made four times longer, ``tries`` times at most; ``None``
    past that (``fn`` waits on the device, or the host is slower than the
    longest spin)."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    lead = FENCE_LEAD_CYCLES
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead)
        spun = torch.cuda.Event()
        spun.record()
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        queued = not spun.query()
        stop.synchronize()
        if queued:
            return start.elapsed_time(stop) / calls
        lead *= 4
    return None
