"""Host ms a training step spends inside the program's ``sgd.step`` span
less its ``host.sync`` spans (the host enqueuing the step's forward,
backward, update and masks, without deliberate waits for the device),
averaged over the steps of the traced window."""
from hapm_bench import program_spans


def read(c):
    window = program_spans.window_units("sgd.step", c.units)
    if window is None:
        return None
    return sum(root.ms - sum(s.ms for s in below if s.name == "host.sync")
               for root, below in window) / len(window)
