"""The traced window of a ``--trace 1`` run: the PyTorch profiler over the
first seconds of the measured window, the benchmark's own host spans around
its calls into the program, and the reduction of the trace to what the
per-layer metrics read (device activity, its union, idle gaps named by the
host span that was open, device time by kernel name)."""
from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path

import torch

# a spin kernel before the window opens: on an H100 the profiler can lose
# the records at the start of a session, and the lead is what it loses
FENCE_CYCLES = 20_000_000
WINDOW_SPAN = "bench.window"


def kernel_base_name(name: str) -> str:
    """``void ns::kernel_name<T, 4>(args)`` -> ``kernel_name``."""
    name = re.sub(r"^(void|auto)\s+", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


def kernel_groups(root: Path) -> dict:
    """{group: set of kernel base names}, one name a line, from every file
    ``kernel_names/<group>/*.txt``."""
    out: dict = {}
    for f in sorted((root / "kernel_names").glob("*/*.txt")):
        names = {ln.strip() for ln in f.read_text().splitlines()
                 if ln.strip() and not ln.startswith("#")}
        out.setdefault(f.parent.name, set()).update(names)
    return out


class Tracer:
    """Opens the profiler at the window's start (``start``) and closes it
    once ``seconds`` have passed at a unit boundary (``maybe_stop``); with
    ``on`` False every method does nothing. ``span(name)`` marks a host span
    while the profiler runs."""

    def __init__(self, on: bool, seconds: float, device):
        self.on, self.seconds, self.device = on, seconds, torch.device(device)
        self.active = False
        self.summary = None
        self.units = 0
        self.spans: set = set()
        self._prof = self._window = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda._sleep(FENCE_CYCLES)
            torch.cuda.synchronize(self.device)
        self._window = record_function(WINDOW_SPAN)
        self._window.__enter__()
        self._t0 = time.monotonic()
        self.active = True

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        self.spans.add(name)
        return record_function(name)

    def maybe_stop(self, units: int) -> None:
        """Close the traced window after ``units`` units (requests or
        steps) once its seconds have passed; the caller has just finished a
        unit."""
        if self.active and time.monotonic() - self._t0 >= self.seconds:
            self.stop(units)

    def stop(self, units: int) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self.units = units
        self.summary = summarize(self._prof.events(), self.spans)
        self._prof = None


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, spans: set) -> dict:
    """The trace reduced to the window: ``window_us``; ``device``: every
    device event (kernel, copy, memset) inside it as (name, start, end) in
    µs; ``busy_us``, the union of their time; ``ops``: {name: (µs,
    count)}; ``gaps``: {host span: µs of device idleness while it was
    open}, the host spans being the benchmark's own (``spans``), one at a
    time."""
    from torch.autograd import DeviceType
    window = None
    host, device = [], []
    for e in events:
        name, tr = e.name, e.time_range
        if name == WINDOW_SPAN:
            if e.device_type == DeviceType.CPU:
                window = (tr.start, tr.end)
        elif name in spans:
            if e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, name))
        elif e.device_type != DeviceType.CPU:
            device.append((name, tr.start, tr.end))
    if window is None:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1 = window
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy = _union((s, e) for _, s, e in device)
    ops: dict = {}
    for n, s, e in device:
        us, c = ops.get(n, (0.0, 0))
        ops[n] = (us + (e - s), c + 1)
    idle, t = [], w0
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < w1:
        idle.append((t, w1))
    gaps: dict = {}
    host.sort()
    j = 0
    for s, e in idle:
        while j < len(host) and host[j][1] <= s:
            j += 1
        covered, k = 0.0, j
        while k < len(host) and host[k][0] < e:
            lo, hi = max(s, host[k][0]), min(e, host[k][1])
            if hi > lo:
                gaps[host[k][2]] = gaps.get(host[k][2], 0.0) + (hi - lo)
                covered += hi - lo
            k += 1
        if e - s > covered:
            gaps["(no span)"] = gaps.get("(no span)", 0.0) + (e - s - covered)
    return {"window_us": w1 - w0, "device": device,
            "busy_us": sum(e - s for s, e in busy), "ops": ops, "gaps": gaps}


def group_device_us(summary: dict, names: set) -> float:
    """Device µs of the events whose kernel base name is in ``names``."""
    return sum(us for n, (us, _) in summary["ops"].items()
               if kernel_base_name(n) in names)


def breakdown(summary: dict) -> dict:
    """The ten device operations that took the most time and the ten
    longest idle shares by host span, in seconds."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, (us, _) in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}
