"""A training step's needed float32 operations (the forward, the input
gradient but for the first layer's, and the weight gradient over the live
weights of every conv, from ``counts/``, and the head's forward and
backward) for the steps of the traced window, over the window's length
times the card's float32 peak outside the tensor cores (67 TFLOP/s), in
%."""
from hapm_bench.counts import conv as counts


def read(c):
    s = c.summary
    if s is None or not c.units or s["window_us"] <= 0:
        return None
    per_step = sum(l["ops"] for i, layer in enumerate(c.layers)
                   for l in counts.train_launches(layer, c.batch, first=(i == 0)))
    per_step += 3 * c.batch * counts.head_ops(c.model)
    return 100.0 * per_step * c.units / (s["window_us"] / 1e6 * c.peaks["f32_flops_s"])
