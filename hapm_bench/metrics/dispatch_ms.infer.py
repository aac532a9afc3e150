"""Host ms a request spends inside the program's ``cnn.forward`` spans (the
host enqueuing the served network's operations: every conv, residual add
and the head), averaged over the requests of the traced window."""
from hapm_bench import program_spans


def read(c):
    return program_spans.ms_per_unit("serve.request", c.units, "cnn.forward")
