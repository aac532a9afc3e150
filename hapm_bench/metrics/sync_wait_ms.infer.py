"""Host ms a request spends inside the program's ``host.sync`` spans (the
host waiting for the device: the server's non-finite guard reads each
chunk's logits), averaged over the requests of the traced window."""
from hapm_bench import program_spans


def read(c):
    return program_spans.ms_per_unit("serve.request", c.units, "host.sync")
