"""The port's one recorder of host-side spans and counters.

``span(name, **attrs)`` marks a stretch of host time on a path of the
program (a request, a chunk, a conv, a training step and its parts). It is
on exactly while a torch profiler session records, and costs one check
otherwise: whoever profiles the program (``torch.profiler.profile``) gets
the spans in the same trace as the operators and the device's kernels, on
the profiler's clock, and in :func:`spans` as records on the host's
``perf_counter_ns`` clock. A span enters the profiler as a
``_RecordFunctionFast`` range, which is not a user annotation: on CUDA the
profiler adds no device-side event for it, so the device trace holds only
what ran on the device.

Spans nest per thread: one opened inside another is its child, and every
span of one request or step carries its root's id. The records are kept in
a ring of ``MAX_SPANS``; each one that a new record pushes out is counted in
the ``tracing.dropped`` counter.

``count(name, n)`` adds to a counter that is always on (the kernels' launch
counts, the binds and their time, requests and steps), read with
:func:`counters` or :func:`counter`.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

MAX_SPANS = 200_000
DROPPED = "tracing.dropped"


class Span(NamedTuple):
    name: str
    id: int
    parent: int          # 0 for a root
    root: int            # the root's id (its own for a root)
    t_start_ns: int      # time.perf_counter_ns()
    t_end_ns: int
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.t_end_ns - self.t_start_ns) / 1e6


_spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a program that no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "root", "t0", "fast", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = self.stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        stack.append(self)
        self.fast = _RecordFunctionFast(self.name)
        self.fast.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.fast.__exit__(*exc)
        self.stack.pop()
        if len(_spans) == _spans.maxlen:
            count(DROPPED)
        _spans.append(Span(self.name, self.id, self.parent, self.root,
                           self.t0, t1, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span has begun."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager over a stretch of host time named ``name``: a
    recorded span while a profiler session records, else the shared
    :data:`OFF`."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _On(name, attrs)


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; returns its new value."""
    v = _counters.get(name, 0) + n
    _counters[name] = v
    return v


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters() -> Dict[str, int]:
    return dict(_counters)


def spans() -> List[Span]:
    """The recorded spans, oldest first (a span is recorded when it ends,
    so a child comes before its parent)."""
    return list(_spans)


def reset(*names: str) -> None:
    """Set the named counters to zero; with no name, forget every span and
    counter."""
    if names:
        for name in names:
            _counters.pop(name, None)
    else:
        _spans.clear()
        _counters.clear()

