"""What the port's own recorder (``repro_torch.tracing``) holds of a traced
window, for the readers of ``program_span`` and ``program_counter`` metrics.

The recorder keeps spans exactly while a profiler records. In a traced run
that is the traced window, which runs ``units`` units (a request is one
``serve.request`` root span, a training step one ``sgd.step``) and nothing
else, so the window's spans are those of the last ``units`` roots of that
name: no reset and no hook in the runners is needed, and a later window in
the same process hides an earlier one. Where the program has no recorder
(a tree older than it), every reader here gives None."""
from __future__ import annotations


def recorder():
    """The port's recorder module, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def window_units(root: str, units: int):
    """[(root span, [every span below it])] of the last ``units`` roots
    named ``root``, oldest first; None where the program has no recorder
    or it holds fewer such roots."""
    tracing = recorder()
    if tracing is None or not units:
        return None
    spans = tracing.spans()
    roots = [s for s in spans if s.id == s.root and s.name == root][-units:]
    if len(roots) < units:
        return None
    below = {r.id: [] for r in roots}
    for s in spans:
        if s.root in below and s.id != s.root:
            below[s.root].append(s)
    return [(r, below[r.id]) for r in roots]


def ms_per_unit(root: str, units: int, name: str):
    """Host ms a unit spent inside the spans named ``name`` below its
    root, averaged over the window's units."""
    window = window_units(root, units)
    if window is None:
        return None
    return sum(s.ms for _, below in window for s in below if s.name == name) / len(window)
