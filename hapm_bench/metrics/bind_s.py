"""Host seconds the run's process spent binding the network onto the
kernels (the program's always-on counter ``cnn.bind_ns``): the binds of
set-up, as the window's lookups all hit."""
from hapm_bench import program_spans


def read(c):
    tracing = program_spans.recorder()
    if tracing is None or not tracing.counter("cnn.binds"):
        return None
    return tracing.counter("cnn.bind_ns") / 1e9
