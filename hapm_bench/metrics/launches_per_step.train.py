"""Device operations (kernels, copies, memsets) per training step in the
traced window."""


def read(c):
    if c.summary is None or not c.units or not c.summary["device"]:
        return None
    return len(c.summary["device"]) / c.units
