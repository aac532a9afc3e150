"""The training kernels' share of their roofline: over the steps of the
traced window, the sum of the needed bound of each conv's forward, input
gradient (not the first layer's) and weight gradient (the larger of the
operations over the float32 peak and the bytes over the memory rate, from
``counts/``), over the device time of the kernels named in
``kernel_names/train_sparse/``, in %."""
from hapm_bench.counts import conv as counts
from hapm_bench.trace import group_device_us


def read(c):
    if c.summary is None or not c.units:
        return None
    busy_us = group_device_us(c.summary, c.groups.get("train_sparse", set()))
    if busy_us <= 0:
        return None
    need = sum(counts.bound_s(l, c.peaks["f32_flops_s"], c.peaks["bytes_s"])
               for i, layer in enumerate(c.layers)
               for l in counts.train_launches(layer, c.batch, first=(i == 0)))
    return 100.0 * c.units * need / (busy_us / 1e6)
