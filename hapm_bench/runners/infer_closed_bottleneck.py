"""Closed-loop bulk inference of an ImageNet ResNet with bottleneck blocks
(``model.block`` ``"bottleneck"``, ``model.stem`` ``"imagenet"``): the
traffic, the window and its end-to-end metrics are ``infer_closed``'s; the
network, its weights and BatchNorm state, its layer list and the reference
it is checked against are this file's.

Weights are drawn from the seed (He-normal convs, a head of std
sqrt(1/channels), BN scale 1 and bias 0). The BN running statistics are
measured by the reference's float32 forward over ``CALIB_FRAMES`` seeded
frames, through the network the reference's HAPM masks prune, so that every
BN output is standardized as training leaves it: BN as initialized would
let the residual adds of a deep stage saturate the Q3.4 wire.

Mix parameters: those of ``infer_closed``."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from hapm_bench import inputs, model
from hapm_bench.counts import conv as counts
from hapm_bench.reference import resnet_bottleneck as ref
from hapm_bench.runners.infer_closed import (ORDER_LEN, _checked_slices,  # noqa: F401
                                             _logit_gap, _request, end_to_end,
                                             release, window)
from hapm_bench.trace import kernel_groups

REF_BLOCK = 32         # frames the reference computes at a time
CALIB_FRAMES = 64      # frames the BN statistics are measured on
CHIPS = (1,)
FAULTS = ("altered_answer",)
CONTROL_ON_CPU = True


def resnet_config(m: dict):
    from repro_torch.models import cnn
    return cnn.ResNetConfig(block=m["block"], stem=m["stem"], stages=tuple(m["stages"]),
                            widths=tuple(m["widths"]), num_classes=m["num_classes"],
                            in_channels=m["in_channels"], image_size=m["image_size"],
                            bn_eps=m["bn_eps"])


def make_weights(m: dict, seed: int, device):
    """(params, state) with BN as initialized: He-normal convs, a head of
    std sqrt(1/channels) and a zero head bias, from one normal draw on
    ``device``; the keys and layouts the port's ``models/cnn.py`` takes."""
    layers = ref.layers(m)
    width, classes = layers[-1]["cout"], m["num_classes"]
    sizes = [l["k"] ** 2 * l["cin"] * l["cout"] for l in layers]
    z = torch.randn(sum(sizes) + width * classes,
                    generator=inputs.generator(seed, "weights", device), device=device)
    params: dict = {}
    state: dict = {}
    off = 0
    for layer, n in zip(layers, sizes):
        k, cin, cout = layer["k"], layer["cin"], layer["cout"]
        path = layer["path"]
        p = params if len(path) == 2 else params.setdefault(path[0], {})
        s = state if len(path) == 2 else state.setdefault(path[0], {})
        bn = ref.BN_OF[path[-2]]
        p[path[-2]] = {"w": z[off:off + n].reshape(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5}
        p[bn] = {"scale": torch.ones(cout, device=device),
                 "bias": torch.zeros(cout, device=device)}
        s[bn] = {"mean": torch.zeros(cout, device=device),
                 "var": torch.ones(cout, device=device)}
        off += n
    params["fc"] = {"w": z[off:].reshape(width, classes) * (1.0 / width) ** 0.5,
                    "b": torch.zeros(classes, device=device)}
    return params, state


def calibrated_state(params: dict, m: dict, pruning: dict, seed: int, device) -> tuple:
    """(the BN running statistics the reference's float32 forward measures
    over ``CALIB_FRAMES`` seeded frames through the network the reference's
    HAPM masks prune, those masks), the masks kept for the check."""
    masks = ref.hapm_masks(params, m, pruning)
    frames, _ = inputs.make_frames(CALIB_FRAMES, m, seed, "calibration", device)
    with torch.no_grad():
        return ref.f32_logits(params, None, m, frames, masks)[1], masks


def setup(ctx) -> dict:
    from repro_torch.launch.serve_cnn import CnnServer
    from repro_torch.models import cnn

    config, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m = config["model"]
    cfg = resnet_config(m)        # first: a program without the network stops here
    params, _ = make_weights(m, ctx.seed, dev)
    state, masks = calibrated_state(params, m, config["pruning"], ctx.seed, dev)
    pruned = model.program_pruning(config, params)
    server = CnnServer(pruned["params"], state, cfg, spec=cnn.ExecSpec(**config["exec_spec"]),
                       buckets=tuple(mix["buckets"]), device=dev)
    server.warmup()
    frames, _ = inputs.make_frames(mix["pool_frames"], m, ctx.seed, "pool", dev)
    pool = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=dev.type == "cuda")
    pool.copy_(frames)
    del frames
    n = mix["request_frames"]
    order = torch.randint(mix["pool_frames"] // n, (ORDER_LEN,),
                          generator=inputs.generator(ctx.seed, "order", "cpu"))
    run = {"server": server, "pool": pool, "order": order.tolist(), "n": n,
           "pruned": pruned["params"], "raw": (params, state, masks)}
    for i in range(mix["warm_requests"]):
        server.infer(_request(run, i)).cpu()
    return run


def layer_inputs(ctx, run: dict, window: dict, tracer):
    m = ctx.cell.config["model"]
    layers = ref.layers(m)
    live = counts.live_counts(layers, counts.weights_of(run["pruned"], layers))
    return SimpleNamespace(kind="infer", summary=tracer.summary, units=tracer.units,
                           batch=run["n"], layers=live, model=m, peaks=ctx.peaks,
                           groups=kernel_groups(ctx.root / "hapm_bench"),
                           hits=window["hits"], misses=window["misses"])


def _reference(ctx, window: dict, slices, bits: int) -> dict:
    params, state, masks = window["raw"]
    m = ctx.cell.config["model"]
    n, out = window["n"], {}
    with torch.no_grad():
        for s in slices:
            frames = window["pool"][s * n:(s + 1) * n]
            out[s] = torch.cat([
                ref.served_logits(params, state, masks, m,
                                  frames[lo:lo + REF_BLOCK].to(ctx.device), bits=bits).cpu()
                for lo in range(0, n, REF_BLOCK)])
    return out


def check(ctx, window: dict) -> dict:
    """Every answer served in the window for a seeded sample of pool
    slices, against the reference's logits for those frames."""
    slices = _checked_slices(ctx, window)
    want = _reference(ctx, window, slices, bits=8)
    answers = [(s, y) for s, y in zip(window["slices"], window["outputs"]) if s in want]
    return {"logit_gap": _logit_gap(answers, want)}


def control(ctx, window: dict) -> dict:
    """The reference in int4 put in the program's place, judged the same
    way."""
    slices = _checked_slices(ctx, window)
    want = _reference(ctx, window, slices, bits=8)
    low = _reference(ctx, window, slices, bits=4)
    return {"logit_gap": _logit_gap(list(low.items()), want)}
