"""Training steps back to back: the port's ``make_sparse_train_step`` over a
trainable bind of the configuration's pruned network (its QAT view), fed
batches of a pool of seed-drawn labelled frames held on the device, the
pool reshuffled every epoch, each batch randomly cropped (zero padding)
and flipped on the device. Set-up drives the step through its first
``checked_steps`` steps, which the reference follows; the window continues
with the same step, weights, state and optimizer state.

Mix parameters (``traffic/<mix>.json``): ``batch``, ``pool_frames``,
``crop_pad``, ``lr``, ``momentum``, ``weight_decay``, ``checked_steps``,
``trace_seconds``."""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from hapm_bench import inputs, model
from hapm_bench.counts import conv as counts
from hapm_bench.reference import sgd as ref_sgd
from hapm_bench.trace import kernel_groups

# leaves whose reference gradient is below this share of the median leaf's
# move by round-off alone and are left out of the change compared
STILL_LEAF = 1e-3
CHIPS = (1,)                            # the chips a cell of this mix may ask for
FAULTS = ("frozen_state", "half_batch")  # the faults of ``faults.py`` such a cell can have
CONTROL_ON_CPU = False                  # the control is TF32: only the card has it


class Feed:
    """Seeded batches of the pool: a new permutation each epoch (the last
    partial batch dropped), a random crop of the zero-padded frame and a
    random horizontal flip, all drawn on the device."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.frames, self.labels = inputs.make_frames(
            mix["pool_frames"], config["model"], seed, "pool", device)
        self.gen = inputs.generator(seed, "feed", device)
        self.batch, self.pad, self.device = mix["batch"], mix["crop_pad"], device
        self.perm, self.pos = None, 0
        h = config["model"]["image_size"]
        self.span = torch.arange(h, device=device)

    def next(self) -> dict:
        n, b = self.frames.shape[0], self.batch
        if self.perm is None or self.pos + b > n:
            self.perm = torch.randperm(n, generator=self.gen, device=self.device)
            self.pos = 0
        idx = self.perm[self.pos:self.pos + b]
        self.pos += b
        p = self.pad
        x = F.pad(self.frames[idx], (0, 0, p, p, p, p))
        oy, ox = (torch.randint(2 * p + 1, (b,), generator=self.gen, device=self.device)
                  for _ in range(2))
        rows = (oy[:, None] + self.span)[:, :, None]
        cols = (ox[:, None] + self.span)[:, None, :]
        x = x[torch.arange(b, device=self.device)[:, None, None], rows, cols]
        flip = torch.rand(b, generator=self.gen, device=self.device) < 0.5
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return {"x": x.contiguous(), "y": self.labels[idx]}


def setup(ctx) -> dict:
    from repro_torch.models import cnn
    from repro_torch.train import cnn_training
    from repro_torch.train.optimizer import sgd

    config, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    params, state = inputs.make_weights(config["model"], ctx.seed, dev)
    pruned = model.program_pruning(config, params)
    cfg = model.resnet_config(config, quantized=True)
    spec = cnn.ExecSpec(**config["train_exec_spec"])
    exec_ = cnn.bind_execution(pruned["params"], cfg, spec=spec,
                               specs=cnn.conv_group_specs(pruned["params"], spec.n_cu),
                               group_masks=pruned["group_masks"], device=dev)
    step = cnn_training.make_sparse_train_step(cfg, exec_)
    opt_init, _ = sgd(momentum=mix["momentum"], weight_decay=mix["weight_decay"])
    feed = Feed(config, mix, ctx.seed, dev)
    run = {"step": step, "feed": feed, "masks": pruned["element_masks"],
           "lr": mix["lr"], "params": pruned["params"], "state": state,
           "opt": opt_init(pruned["params"]), "raw": (params, state)}
    record = {"p0": run["params"], "batches": [], "losses": []}
    for i in range(mix["checked_steps"]):
        batch = feed.next()
        loss = _step(run, batch)
        record["batches"].append((batch["x"], batch["y"]))
        record["losses"].append(loss)
        if i == 0:
            record["m1"] = run["opt"].momentum
    record["p_last"] = run["params"]
    record["losses"] = [float(v) for v in record["losses"]]
    run["record"] = record
    return run


def _step(run: dict, batch: dict):
    run["params"], run["state"], run["opt"], loss = run["step"](
        run["params"], run["state"], run["opt"], run["masks"], batch, run["lr"])
    return loss


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ctx, run: dict, seconds: float, tracer) -> dict:
    feed = run["feed"]
    _sync(ctx.device)
    tracer.start()
    t0 = time.monotonic()
    steps = 0
    while True:
        with tracer.span("train.data"):
            batch = feed.next()
        with tracer.span("train.step"):
            _step(run, batch)
        steps += 1
        tracer.maybe_stop(steps)
        if time.monotonic() - t0 >= seconds:
            break
    _sync(ctx.device)
    window_s = time.monotonic() - t0
    return {"units": steps, "attempted": steps, "failed": 0, "window_s": window_s,
            "frames": steps * feed.batch, "record": run["record"], "raw": run["raw"],
            "batch": feed.batch}


def end_to_end(ctx, run: dict, window: dict) -> dict:
    return {"train_frames_per_s": window["frames"] / window["window_s"]}


def layer_inputs(ctx, run: dict, window: dict, tracer):
    layers = inputs.conv_layers(ctx.cell.config["model"])
    live = counts.live_counts(layers, counts.weights_of(run["params"], layers))
    return SimpleNamespace(kind="train", summary=tracer.summary, units=tracer.units,
                           batch=window["batch"], layers=live,
                           model=ctx.cell.config["model"], peaks=ctx.peaks,
                           groups=kernel_groups(ctx.root / "hapm_bench"))


def release(run: dict) -> None:
    for key in ("step", "feed", "params", "state", "opt", "masks"):
        run.pop(key, None)


def _flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = v
    return out


def _norms(flat: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in flat.items()}


def _leaf_gaps(got: dict, want: dict, keys) -> list:
    """Per leaf, the gap between two norms over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = float(torch.tensor([want[k] for k in keys]).median())
    return sorted(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def compare(got: dict, want: dict, decay: float, masks: dict) -> dict:
    """The program's first steps against the reference's, both as flat
    {leaf path: tensor} dicts (``p0``, ``m1``, ``p_last``) and ``losses``.
    Compared (``limits/<cell>.json``): ``loss_gap``, the first step's loss gap over
    the reference's loss; ``grad_gap``, the first gradient's norms by the
    median leaf (the program's from its optimizer state after one step,
    ``m1 - decay * p0``); ``change_gap``, the norms of the weights' change
    over all the steps by the median leaf, leaves that only round-off
    moves left out; ``pruned_nonzero``, entries the reference prunes that
    the program's first gradient or last weights hold nonzero. Read
    beside them and not compared: ``loss_gap_all`` (the worst step),
    ``grad_gap_worst`` and ``change_gap_worst`` (the worst leaf), which
    the noise of one small leaf and the later steps' code flips make swing
    from seed to seed."""
    p0, m1, last = got["p0"], got["m1"], got["p_last"]
    g1 = {k: m1[k] - decay * p0[k] for k in m1}
    g_got, g_want = _norms(g1), _norms(want["g1"])
    keys = sorted(g_want)
    med = float(torch.tensor([g_want[k] for k in keys]).median())
    moving = [k for k in keys if g_want[k] >= STILL_LEAF * med]
    d_got = _norms({k: last[k] - p0[k] for k in moving})
    d_want = _norms({k: want["p_last"][k] - want["p0"][k] for k in moving})
    change = _leaf_gaps(d_got, d_want, moving)
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    pruned = sum(int(((masks[k].to(m1[k].device) == 0) & ((m1[k] != 0) | (last[k] != 0))).sum())
                 for k in masks)
    grad = _leaf_gaps(g_got, g_want, keys)
    return {"loss_gap": losses[0], "grad_gap": grad[len(grad) // 2],
            "change_gap": change[len(change) // 2], "pruned_nonzero": pruned,
            "loss_gap_all": max(losses), "grad_gap_worst": grad[-1],
            "change_gap_worst": change[-1]}


def _reference(ctx, window: dict, tf32: bool) -> tuple:
    params, _ = window["raw"]
    masks = model.reference_masks(ctx.cell.config, params)
    return ref_sgd.train_steps(params, masks, window["record"]["batches"],
                               ctx.cell.config["model"], ctx.cell.traffic, tf32=tf32), masks


def check(ctx, window: dict) -> dict:
    rec = window["record"]
    got = {k: _flat(rec[k]) for k in ("p0", "m1", "p_last")}
    got["losses"] = rec["losses"]
    want, masks = _reference(ctx, window, tf32=False)
    return compare(got, want, ctx.cell.traffic["weight_decay"], masks)


def control(ctx, window: dict) -> dict:
    """The reference with TF32 matrix products put in the program's place,
    judged the same way."""
    want, masks = _reference(ctx, window, tf32=False)
    low, _ = _reference(ctx, window, tf32=True)
    decay = ctx.cell.traffic["weight_decay"]
    low["m1"] = {k: low["g1"][k] + decay * low["p0"][k] for k in low["g1"]}
    return compare(low, want, decay, masks)
