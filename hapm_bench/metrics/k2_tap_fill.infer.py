"""Share of the K rows K2 multiplied in the run that carry a real tap (an
input channel's kx x ky taps, not the packed layout's slot or channel
padding), in %: the program's always-on counters
``kernel.implicit_block_sparse_conv.tap_rows`` over ``...k_rows``, set-up
included (the program counts the plain version's calls on the CPU too).
None where K2 ran nothing or the program has no such counter (a tree older
than it)."""
from hapm_bench import program_spans


def read(c):
    tracing = program_spans.recorder()
    if tracing is None:
        return None
    try:
        from repro_torch.kernels import implicit_conv
    except ImportError:
        return None
    k_rows, tap_rows = (getattr(implicit_conv, name, None) for name in ("K_ROWS", "TAP_ROWS"))
    if k_rows is None or tap_rows is None or not tracing.counter(k_rows):
        return None
    return 100.0 * tracing.counter(tap_rows) / tracing.counter(k_rows)
