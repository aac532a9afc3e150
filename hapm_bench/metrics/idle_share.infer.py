"""The share of the traced window in which no operation ran on the device
(the window less the union of all kernels, copies and memsets), in %."""


def read(c):
    s = c.summary
    if s is None or not s["device"] or s["window_us"] <= 0:
        return None
    return 100.0 * (s["window_us"] - s["busy_us"]) / s["window_us"]
