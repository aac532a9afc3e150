"""The multi-pod dry-run as a walk of meta tensors, the twin of the JAX
package's ``launch/dryrun.py``.

For every (architecture × input shape) cell on the production meshes it
builds the cell's entry point (the train step, prefill or decode) with
every argument a meta tensor (the weights, the optimizer state, the group
masks, the batch and the caches: shapes and dtypes, no memory), walks it
once and records:

- **argument bytes per device**, from the sharding specs of
  ``dist/sharding.py`` (``make_rules``, ``param_specs``, ``batch_specs``,
  ``cache_specs``) on a shape-only mesh (:class:`ShapeMesh`, a ``{axis:
  size}`` mapping that ``dist.api.mesh_shape`` reads; the production mesh
  of ``launch/mesh.py`` needs the 256 or 512 cards themselves);
- **FLOPs**, by ``torch.utils.flop_counter.FlopCounterMode`` over the walk
  (forward and backward of the train step; prefill; decode);
- **bytes**, the sum of every operation's tensor inputs and outputs (views
  left out): an unfused upper bound, where XLA's "bytes accessed" is
  counted after fusion;
- a **peak estimate** per device: argument bytes, plus the gradients, plus
  the activations autograd saves (``saved_tensors_hooks``; with
  ``cfg.remat`` the layers' inputs and, under ``"dots"``, the weight
  products the policy keeps), divided over the batch shards;
- the model FLOPs and the roofline of ``launch/analysis.py``, at this card's
  constants. Collectives are **not modeled**: ``collectives_in_schedule``
  and ``t_collective_s`` are null, and ``dominant`` is taken over the
  compute and memory terms.

The walk runs the global computation (the whole global batch) with no
rules installed: on local tensors ``constrain`` is the identity, and a
rank's collectives (the MoE's under rules) need the ranks themselves. So
the ``ShardFlags`` change the argument bytes per device, not the counts.

The JAX dry-run compiles each cell and reads XLA's artifacts. XLA's cost
model counts a ``while`` body once, so it extrapolates its costs from
unroll-delta probes (``_smallest_divisor``, ``_structure``, ``_probe_one``,
``probe_costs``). Those have no counterpart here: the port's Python loops
run every layer, micro-batch and KV chunk, and the walk counts each.

One loop is too long to walk: the sLSTM's per-token recurrence at
``prefill_32k``/``train_4k`` would take minutes. The walk runs it over
``SLSTM_WALK_TOKENS`` token and adds the rest, as the JAX package adds it:
FLOPs by :func:`_slstm_correction` (the recurrent products, all that
``FlopCounterMode`` counts of the recurrence), bytes and saved bytes from a
second walk over one token more.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-nemo-12b \\
        --shape train_4k --mesh single --out /tmp/dry.json

No environment is set at import (the JAX module's ``XLA_FLAGS`` has no
counterpart), and nothing runs on a device: the walk is on the meta device
wherever it runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import registry
from ..configs.shapes import SHAPES, input_specs
from ..core.masks import tree_flatten_with_path, tree_leaves, tree_map
from ..dist import sharding as SH
from ..dist.api import P, axes_size
from ..models import lm
from ..models import transformer as TF
from ..models import xlstm as XL
from ..models.lm_config import LMConfig
from ..train.optimizer import AdamWState
from . import analysis as AN
from .train import build_decode, build_prefill, build_train_step, init_group_masks

PyTree = Any
SLSTM_WALK_TOKENS = 1


def hbm_per_chip() -> int:
    """The card's memory when one is present, else 80 GiB."""
    return int(AN.device_peaks()["memory_bytes"])


class ShapeMesh:
    """A mesh of axis sizes only: what the spec derivers read."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def production_mesh(multi_pod: bool) -> ShapeMesh:
    """The shapes of ``launch/mesh.py::make_production_mesh``."""
    if multi_pod:
        return ShapeMesh({"pod": 2, "data": 16, "model": 16})
    return ShapeMesh({"data": 16, "model": 16})


def _spec_like(tree: PyTree, spec: P) -> PyTree:
    return tree_map(lambda _: spec, tree)


def per_device_bytes(tree: PyTree, specs: PyTree, mesh) -> int:
    """Bytes of one device's shards of ``tree`` laid out by ``specs``."""
    by_path = dict(tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P)))
    total = 0
    for path, t in tree_flatten_with_path(tree):
        shards = math.prod(axes_size(mesh, e) for e in by_path[path])
        total += _nbytes(t) // shards
    return total


def build_cell(cfg: LMConfig, shape_name: str, mesh, flags: SH.ShardFlags,
               accum_unroll: int = 1):
    """-> (fn, args, arg specs, rules): the unwrapped entry point, its
    arguments as meta trees, and each argument's specs."""
    sp = SHAPES[shape_name]
    mode = "train" if sp.kind == "train" else "decode"
    rules = SH.make_rules(mesh, mode, flags)

    params = lm.init(None, cfg, device="meta")
    pspecs = SH.param_specs(params, rules)
    ins = input_specs(cfg, shape_name)

    if sp.kind == "train":
        specs = lm.group_specs(params, cfg)
        mdt = torch.bfloat16 if flags.opt_bf16 else torch.float32
        step, opt_init = build_train_step(cfg, specs, accum_unroll=accum_unroll,
                                          opt_moment_dtype=mdt)
        opt = opt_init(params)
        opt = AdamWState(opt.mu, opt.nu, torch.empty((), dtype=torch.int32, device="meta"))
        gm = init_group_masks(specs, device="meta")
        args = (params, opt, gm, ins["batch"])
        arg_specs = (pspecs, AdamWState(pspecs, pspecs, P()), _spec_like(gm, P()),
                     SH.batch_specs(ins["batch"], rules))
        return step, args, arg_specs, rules

    if sp.kind == "prefill":
        return (build_prefill(cfg), (params, ins["batch"]),
                (pspecs, SH.batch_specs(ins["batch"], rules)), rules)

    args = (params, ins["caches"], ins["token"], ins["pos"])
    arg_specs = (pspecs, SH.cache_specs(ins["caches"], rules),
                 SH.batch_specs(ins["token"], rules), SH.batch_specs(ins["pos"], rules))
    return build_decode(cfg), args, arg_specs, rules


# ---------------------------------------------------------------------------
# The walk: FLOPs, bytes and saved activations of one call on meta tensors
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every operation's tensor inputs and outputs; an
    operation whose outputs alias an input without writing it (a view)
    moves none."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        if not (returns and all(r.alias_info is not None and not r.alias_info.is_write
                                for r in returns)):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


class SavedBytes:
    """The storages autograd holds for the backward, each counted once and
    kept referenced (so a freed storage's address cannot count again); the
    arguments' own storages are left out."""

    def __init__(self, args):
        self.skip = {t.untyped_storage()._cdata for t in _tensors(args)}
        self.held: dict = {}
        self.bytes = 0

    def add_storage(self, st) -> None:
        key = st._cdata
        if key not in self.skip and key not in self.held:
            self.held[key] = st
            self.bytes += st.nbytes()

    def pack(self, t):
        if isinstance(t, torch.Tensor):
            self.add_storage(t.untyped_storage())
        return t

    @contextlib.contextmanager
    def counting(self):
        """Count what autograd saves, and under ``cfg.remat == "dots"`` the
        weight products the checkpoint policy keeps (they are held outside
        ``saved_tensors_hooks``)."""
        policy = TF._dots_saveable
        saved = self

        def counting_policy(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if (decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                    and not ctx.is_recompute):
                a, b = args[-2], args[-1]
                saved.bytes += a.shape[0] * b.shape[1] * a.element_size()
            return decision

        TF._dots_saveable = counting_policy
        try:
            with torch.autograd.graph.saved_tensors_hooks(self.pack, lambda t: t):
                yield self
        finally:
            TF._dots_saveable = policy


@contextlib.contextmanager
def _short_slstm(tokens: int, walked: dict):
    """The sLSTM recurrence walked over its first ``tokens`` tokens; the
    hidden states of the others repeat the last walked one (meta tensors:
    only their shapes matter). ``walked["left"]``: the tokens of a sequence
    left out."""
    full = XL.slstm_scan

    def short(carry, wx, r):
        S = wx.shape[1]
        w = min(S, tokens)
        hs, carry = full(carry, wx[:, :w], r)
        walked["left"] = S - w
        if S > w:
            hs = torch.cat([hs, hs[:, -1:].expand(-1, S - w, -1, -1)], dim=1)
        return hs, carry

    XL.slstm_scan = short
    try:
        yield
    finally:
        XL.slstm_scan = full


def _slstm_correction(cfg: LMConfig, sp, kind: str) -> float:
    """Analytic FLOPs for the sLSTM time-recurrence (a seq-length while loop
    the HLO cost model counts once; error of this correction ≤ 1/seq_len).
    Decode runs a single step — already exact, no correction."""
    if kind == "decode" or not (cfg.family == "ssm" and cfg.ssm_state == 0):
        return 0.0
    n_groups = cfg.num_layers // cfg.xlstm_slstm_every
    H = cfg.num_heads
    hd = cfg.d_model // H
    per_tok = 2.0 * 4 * H * hd * hd            # recurrent gate einsum
    mult = 3.0 if kind == "train" else 1.0     # fwd + ~2x bwd
    return mult * n_groups * sp.global_batch * sp.seq_len * per_tok


def _walk_once(fn, args, slstm_tokens: int) -> dict:
    mode = _BytesMode()
    saved = SavedBytes(args)
    walked = {"left": 0}
    flops = FlopCounterMode(display=False)
    t0 = time.time()
    with _short_slstm(slstm_tokens, walked), flops, mode, saved.counting():
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes": float(mode.bytes),
            "saved_bytes": saved.bytes, "walk_s": time.time() - t0,
            "slstm_tokens_left": walked["left"]}


def walk(fn, args, cfg: LMConfig, shape_name: str,
         slstm_tokens: int = SLSTM_WALK_TOKENS) -> dict:
    """FLOPs, bytes and saved-activation bytes of ``fn(*args)`` (global, not
    per device), walked on meta tensors. An sLSTM sequence is walked over
    ``slstm_tokens`` tokens; the others are added: FLOPs by
    :func:`_slstm_correction`, bytes and saved bytes by a second walk over
    one token more (every cost of the recurrence grows by the same amount
    with each token)."""
    sp = SHAPES[shape_name]
    rec = _walk_once(fn, args, slstm_tokens)
    left = rec.pop("slstm_tokens_left")
    if left:
        more = _walk_once(fn, args, slstm_tokens + 1)
        rec["slstm_flops_added"] = _slstm_correction(cfg, sp, sp.kind) * left / sp.seq_len
        rec["flops"] += rec["slstm_flops_added"]
        for k in ("bytes", "saved_bytes"):
            rec[f"slstm_{k}_added"] = left * (more[k] - rec[k])
            rec[k] += rec[f"slstm_{k}_added"]
        rec["walk_s"] += more["walk_s"]
    return rec


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             flags: SH.ShardFlags = SH.ShardFlags(), verbose: bool = True) -> dict:
    mesh = production_mesh(multi_pod)
    cfg = registry.config_for(arch, shape_name)
    sp = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": mesh.size,
           "flags": dataclasses.asdict(flags), "status": "ok"}
    t0 = time.time()
    try:
        fn, args, arg_specs, rules = build_cell(cfg, shape_name, mesh, flags)
        arg_bytes = sum(per_device_bytes(a, s, mesh) for a, s in zip(args, arg_specs))
        batch_shards = math.prod(axes_size(mesh, e) for e in (rules.rules.get("batch"),))
        counted = walk(fn, args, cfg, shape_name)
        grad_bytes = 0
        if sp.kind == "train":
            params, pspecs = args[0], arg_specs[0]
            gdt = torch.float32 if cfg.grad_accum > 1 else None
            grads = tree_map(lambda t: t if gdt is None else t.to(gdt), params)
            grad_bytes = per_device_bytes(grads, pspecs, mesh)
            counted["saved_bytes"] //= max(cfg.grad_accum, 1)   # one micro-batch lives at a time
        saved = counted["saved_bytes"] // batch_shards
        hbm = hbm_per_chip()
        mem = {"argument_bytes": arg_bytes, "gradient_bytes": grad_bytes,
               "saved_activation_bytes": saved,
               "peak_estimate_bytes": arg_bytes + grad_bytes + saved}
        rl = AN.Roofline(chips=mesh.size, flops=counted["flops"], bytes=counted["bytes"],
                         coll_bytes=None)
        mf = AN.model_flops(cfg, sp.kind, sp.seq_len, sp.global_batch)
        rec.update({
            "walk_s": round(counted["walk_s"], 2), "memory": mem,
            "hbm_per_chip_bytes": hbm, "fits_hbm": mem["peak_estimate_bytes"] < hbm,
            "collectives_in_schedule": None,
            "counts": {k: v for k, v in counted.items() if k != "walk_s"},
            "bytes_counting": "unfused upper bound: every operation's tensor inputs "
                              "and outputs, views left out",
            "roofline": rl.as_dict(), "model_flops": mf,
            "useful_compute_ratio": mf / max(rl.flops, 1.0),
        })
        if verbose:
            print(f"[{arch} × {shape_name} × {rec['mesh']}] walked ({rec['walk_s']:.1f}s); "
                  f"per-device bytes: args={arg_bytes/2**30:.2f}GiB "
                  f"grads={grad_bytes/2**30:.2f}GiB saved={saved/2**30:.2f}GiB "
                  f"fits_{hbm/2**30:.0f}GiB={rec['fits_hbm']}")
            print(f"  roofline: comp={rl.t_compute*1e3:.2f}ms mem={rl.t_memory*1e3:.2f}ms "
                  f"coll=not modeled -> {rl.dominant}-bound; model/counted flops="
                  f"{rec['useful_compute_ratio']:.2f}")
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch} × {shape_name}] FAILED: {rec['error']}")
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run (meta-device walk)")
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="dryrun_results_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sp", action="store_true", help="sequence-parallel flag")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--state-shard", action="store_true",
                    help="shard decode state feature dims over model")
    ap.add_argument("--opt-bf16", action="store_true",
                    help="bf16 AdamW moments")
    ap.add_argument("--moe-manual-tp", action="store_true",
                    help="MoE combine-before-reduce manual TP")
    args = ap.parse_args(argv)

    flags = SH.ShardFlags(sp=args.sp, fsdp=not args.no_fsdp,
                          state_shard=args.state_shard,
                          moe_manual_tp=args.moe_manual_tp, opt_bf16=args.opt_bf16)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = []
    for arch, shape, skip in registry.cells(include_skips=True):
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        for mp in meshes:
            key = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}|{flags_key(flags)}"
            if skip is not None:
                results[key] = {"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "status": "skipped", "reason": skip}
                continue
            if key in results and results[key].get("status") == "ok" and not args.force:
                continue
            todo.append((key, arch, shape, mp))

    print(f"{len(todo)} cells to run")
    for i, (key, arch, shape, mp) in enumerate(todo):
        print(f"--- [{i+1}/{len(todo)}] {key}")
        results[key] = run_cell(arch, shape, mp, flags)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results.values() if r.get("status") == "ok")
    err = sum(1 for r in results.values() if r.get("status") == "error")
    sk = sum(1 for r in results.values() if r.get("status") == "skipped")
    print(f"done: {ok} ok, {err} error, {sk} skipped -> {args.out}")
    return 0 if err == 0 else 1


def flags_key(flags: SH.ShardFlags) -> str:
    base = f"fsdp{int(flags.fsdp)}tp{int(flags.tp)}sp{int(flags.sp)}"
    if flags.state_shard:
        base += "ss1"
    if flags.moe_manual_tp:
        base += "mtp1"
    if getattr(flags, "opt_bf16", False):
        base += "ob1"
    return base


if __name__ == "__main__":
    raise SystemExit(main())
