"""The served network's needed int8 operations (2 x the live
multiply-adds of every conv, from ``counts/``, and the head) for the frames
answered in the traced window, over the window's length times the card's
int8 peak, in %."""
from hapm_bench.counts import conv as counts


def read(c):
    s = c.summary
    if s is None or not c.units or s["window_us"] <= 0:
        return None
    per_frame = sum(2 * counts.macs(layer) for layer in c.layers) + counts.head_ops(c.model)
    frames = c.units * c.batch
    return 100.0 * per_frame * frames / (s["window_us"] / 1e6 * c.peaks["int8_ops_s"])
