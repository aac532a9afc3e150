"""Closed-loop bulk inference: one client hands the server requests of
``request_frames`` frames, each a slice of a pool of seed-drawn frames held
in pinned host memory, taken in a seeded order, and waits for the logits on
the host before it sends the next. The entry is the port's
``CnnServer.infer`` under the configuration's serving contract.

Mix parameters (``traffic/<mix>.json``): ``request_frames``, ``buckets``,
``pool_frames``, ``warm_requests`` (whole requests in set-up),
``trace_seconds`` and ``check_slices`` (pool slices whose every answer the
reference checks)."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from hapm_bench import inputs, model
from hapm_bench.counts import conv as counts
from hapm_bench.reference import resnet as ref
from hapm_bench.trace import kernel_groups

ORDER_LEN = 50_000     # requests in the seeded order, taken cyclically
REF_BLOCK = 512        # frames the reference computes at a time
CHIPS = (1,)                     # the chips a cell of this mix may ask for
FAULTS = ("altered_answer",)     # the faults of ``faults.py`` such a cell can have
CONTROL_ON_CPU = True            # the int4 control runs on the CPU too


def setup(ctx) -> dict:
    from repro_torch.launch.serve_cnn import CnnServer
    from repro_torch.models import cnn

    config, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    params, state = inputs.make_weights(config["model"], ctx.seed, dev)
    pruned = model.program_pruning(config, params)
    server = CnnServer(pruned["params"], state, model.resnet_config(config),
                       spec=cnn.ExecSpec(**config["exec_spec"]),
                       buckets=tuple(mix["buckets"]), device=dev)
    server.warmup()
    frames, _ = inputs.make_frames(mix["pool_frames"], config["model"], ctx.seed,
                                   "pool", dev)
    pool = torch.empty(frames.shape, dtype=frames.dtype,
                       pin_memory=dev.type == "cuda")
    pool.copy_(frames)
    del frames
    n = mix["request_frames"]
    order = torch.randint(mix["pool_frames"] // n, (ORDER_LEN,),
                          generator=inputs.generator(ctx.seed, "order", "cpu"))
    run = {"server": server, "pool": pool, "order": order.tolist(), "n": n,
           "pruned": pruned["params"], "raw": (params, state)}
    for i in range(mix["warm_requests"]):
        server.infer(_request(run, i)).cpu()
    return run


def _request(run: dict, i: int) -> torch.Tensor:
    s, n = run["order"][i % ORDER_LEN], run["n"]
    return run["pool"][s * n:(s + 1) * n]


def window(ctx, run: dict, seconds: float, tracer) -> dict:
    server = run["server"]
    lat, outs, used = [], [], []
    before = server.stats()
    tracer.start()
    t0 = time.monotonic()
    i = 0
    while True:
        with tracer.span("traffic.next"):
            x = _request(run, i)
        t_req = time.monotonic()
        with tracer.span("server.infer"):
            y = server.infer(x)
        with tracer.span("client.readback"):
            y = y.cpu()
        t_done = time.monotonic()
        lat.append(t_done - t_req)
        outs.append(y)
        used.append(run["order"][i % ORDER_LEN])
        i += 1
        tracer.maybe_stop(i)
        if t_done - t0 >= seconds:
            break
    window_s = time.monotonic() - t0
    after = server.stats()
    return {"units": i, "attempted": i, "failed": 0, "latency_s": lat,
            "outputs": outs, "slices": used, "window_s": window_s,
            "frames": i * run["n"], "hits": after["hits"] - before["hits"],
            "misses": after["misses"] - before["misses"],
            "raw": run["raw"], "pool": run["pool"], "n": run["n"]}


def end_to_end(ctx, run: dict, window: dict) -> dict:
    return {"infer_frames_per_s": window["frames"] / window["window_s"],
            "infer_request_p95_ms": float(np.percentile(window["latency_s"], 95)) * 1e3}


def layer_inputs(ctx, run: dict, window: dict, tracer):
    layers = inputs.conv_layers(ctx.cell.config["model"])
    live = counts.live_counts(layers, counts.weights_of(run["pruned"], layers))
    return SimpleNamespace(kind="infer", summary=tracer.summary, units=tracer.units,
                           batch=run["n"], layers=live, model=ctx.cell.config["model"],
                           peaks=ctx.peaks, groups=kernel_groups(ctx.root / "hapm_bench"),
                           hits=window["hits"], misses=window["misses"])


def release(run: dict) -> None:
    run.pop("server", None)
    run.pop("pruned", None)


def _reference(ctx, window: dict, slices, bits: int) -> dict:
    params, state = window["raw"]
    masks = model.reference_masks(ctx.cell.config, params)
    n, out = window["n"], {}
    for s in slices:
        frames = window["pool"][s * n:(s + 1) * n]
        out[s] = torch.cat([
            ref.served_logits(params, state, masks, ctx.cell.config["model"],
                              frames[lo:lo + REF_BLOCK].to(ctx.device), bits=bits).cpu()
            for lo in range(0, n, REF_BLOCK)])
    return out


def _checked_slices(ctx, window: dict) -> list:
    served = sorted(set(window["slices"]))
    gen = inputs.generator(ctx.seed, "check", "cpu")
    pick = torch.randperm(len(served), generator=gen)[:ctx.cell.traffic["check_slices"]]
    return [served[int(i)] for i in pick]


def _logit_gap(answers: dict, want: dict) -> float:
    """The widest gap between an answer's logits and the reference's, over
    the largest magnitude of the reference's logits."""
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((a.double() - want[s]).abs().max()) for s, a in answers) / top


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
