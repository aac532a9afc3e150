"""The int8 conv kernels' share of their roofline: over the launches of
the traced window, the sum of each launch's needed bound (the larger of
its operations over the int8 peak and its bytes over the memory rate, from
``counts/``), over the device time of the kernels named in
``kernel_names/conv_int8/``, in %. One launch per conv layer and request."""
from hapm_bench.counts import conv as counts
from hapm_bench.trace import group_device_us


def read(c):
    if c.summary is None or not c.units:
        return None
    busy_us = group_device_us(c.summary, c.groups.get("conv_int8", set()))
    if busy_us <= 0:
        return None
    need = sum(counts.bound_s(counts.served_launch(layer, c.batch),
                              c.peaks["int8_ops_s"], c.peaks["bytes_s"])
               for layer in c.layers)
    return 100.0 * c.units * need / (busy_us / 1e6)
