"""Share of K2's launches in the run that took its int8 instance's resident
path (weight-stationary blocks walking M-blocks), in %: the program's
always-on counters ``kernel.implicit_block_sparse_conv.resident`` over
``kernel.implicit_block_sparse_conv.launches``, set-up included. 0 where K2
launched nothing (the plain versions on the CPU); None where the program
has no such counter (a tree older than the resident path)."""
from hapm_bench import program_spans


def read(c):
    tracing = program_spans.recorder()
    if tracing is None:
        return None
    try:
        from repro_torch.kernels import implicit_conv
    except ImportError:
        return None
    resident = getattr(implicit_conv, "RESIDENT", None)
    if resident is None:
        return None
    launches = tracing.counter(implicit_conv.LAUNCHES)
    return 100.0 * tracing.counter(resident) / launches if launches else 0.0
