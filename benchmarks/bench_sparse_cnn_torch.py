"""Executed group sparsity on the PyTorch/CUDA port: the twin of
``benchmarks/bench_sparse_cnn.py``. HAPM masks go through the port's
block-sparse kernels (``src/repro_torch``) on both tile layouts and both
data-movement contracts, at group sparsity 0/25/50/75 % on the reference's
reduced CNN (3 stages, 16×16 frames), and each level reports dense-vs-sparse
dispatched grid steps, wall clock, parity with the dense path and the cycle
model's DSB prediction for the same masks.

The columns keep the reference's names and meanings (see its docstring).
The port adds a ``device_`` twin beside each timed column: the device time
of the same call from ``torch.profiler`` (every CUDA kernel and copy it
puts on the card, summed), so that a wall ratio can be read against the
same ratio with the host's Python glue taken out. The ``device_`` columns
are ``None`` off CUDA.

The deterministic claims stay hard asserts of :func:`run`: the schedule
accounting equals the cycle model's, the int8, streamed and skip parities
are exactly 0, the sweep is monotone, and the 50 % row keeps the
reference's floors on steps, bytes, utilization, errors and gradients. The
three wall-clock floors (implicit ÷ materializing ≥ 1.3, DSB speedup ≥ 1.2,
dense-activation ratio ≥ 0.95) are recorded in the 50 % row's
``wall_floors`` with a pass/fail verdict and enforced by
``benchmarks.check_sparse_regression_torch``.

Run on the GPU (the default device), or on the CPU where every kernel
wrapper runs its plain PyTorch version (the wall columns then time the CPU):

    PYTHONPATH=src python -m benchmarks.bench_sparse_cnn_torch [--fast]
    PYTHONPATH=src python -m benchmarks.bench_sparse_cnn_torch --device cpu --fast --out /tmp/b.json

It writes ``BENCH_sparse_cnn_torch.json`` (or ``--out``), never the
reference's ``BENCH_sparse_cnn.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.check_sparse_regression_torch import WALL_FLOORS
from repro_torch.accel import BOARDS, simulate
from repro_torch.core import (HAPMConfig, HAPMState, apply_masks,
                              hapm_element_masks, hapm_epoch_update, hapm_init)
from repro_torch.core.masks import tree_flatten_with_path, tree_map, tree_map_with_path
from repro_torch.core.quant import f32_parity_is_exact
from repro_torch.kernels import (profile_device_records, queued_device_ms, record_mismatch,
                                 records_by_kernel, scaled_device_us)
from repro_torch.models import cnn
from repro_torch.train.loop import value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_JSON = os.path.join(ROOT, "BENCH_sparse_cnn_torch.json")

SWEEP = (0.0, 0.25, 0.5, 0.75)
N_CU = 12                                   # the paper's CU count
CFG = cnn.ResNetConfig(stages=(1, 1, 2), widths=(16, 32, 64), image_size=16)
REPS, TRAIN_REPS = 5, 3                     # blocking reps per wall (min of)
# device time per call: the median over DEVICE_SESSIONS profiler sessions, each
# opened on an idle device and holding enough back-to-back calls (at least
# DEVICE_REPS, at most DEVICE_MAX_CALLS) for about DEVICE_WINDOW_MS of device work
DEVICE_REPS, DEVICE_SESSIONS, DEVICE_WINDOW_MS, DEVICE_MAX_CALLS = 3, 3, 1.0, 1000
# a session in which the profiler records no device event at all (seen on an
# H100 between two good sessions of the same call), or another number of
# launches of the port's kernels than the wrappers made (records lost at a
# window's start or taken from the window before, seen on an H100), is opened
# again, at most this many times per reading, after a pause that doubles from
# DEVICE_RETRY_PAUSE_S (the losses come in bursts of ~0.1 s on an H100);
# ``Timer.empty_sessions`` and ``Timer.short_sessions`` count them
DEVICE_EMPTY_RETRIES = 3
DEVICE_RETRY_PAUSE_S = 0.1
DSB_LAYER = ("s2b0", "conv1", "w")          # 32 -> 64, stride 2, 8x8 in
TIMED = ("wall_*_ms / train_step_*_ms: min over {reps} (training {train_reps}) "
         "blocking calls after one warmup; on CUDA, CUDA events around each call "
         "with the stream idle before it and a synchronize at each stop, so the "
         "host's Python glue is included. device_*_ms: torch.profiler's "
         "device-side kernel and copy time per call, the median of {device_sessions} "
         "sessions, each opened on an idle device over back-to-back calls (at least "
         "{device_reps}) that hold about {device_window_ms} ms of device work. "
         "A session in which the profiler kept no record of a launched kernel, past "
         "its retries, is timed instead by CUDA events around the same calls queued "
         "behind a spin kernel (device_event_sessions).")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Timer:
    """The reference's statistic on a device: min over blocking reps after a
    warmup (a single scheduler spike inflates a mean and flips the
    near-threshold ratios, the min estimates the uncontended cost), plus the
    device time of the same call from the profiler on CUDA."""

    device: torch.device
    reps: int = REPS
    empty_sessions: int = 0         # profiler sessions that recorded nothing
    short_sessions: int = 0         # ... or not each kernel launch, once
    scaled_sessions: int = 0        # short past the retries: kernel time per record
    event_sessions: int = 0         # ... and a kernel with no record: CUDA events

    def times(self, fn, *a, reps=None):
        """(last output, [seconds of each of ``reps`` blocking ``fn(*a)``
        calls]), each started on an idle device; no warmup."""
        out, dts = None, []
        for _ in range(reps or self.reps):
            _sync(self.device)
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a)
                stop.record()
                torch.cuda.synchronize(self.device)
                dts.append(start.elapsed_time(stop) / 1e3)
            else:
                t0 = time.perf_counter()
                out = fn(*a)
                dts.append(time.perf_counter() - t0)
        return out, dts

    def wall(self, fn, *a, reps=None):
        """(last output, min seconds of one blocking ``fn(*a)``)."""
        fn(*a)                                       # warmup
        out, dts = self.times(fn, *a, reps=reps)
        return out, min(dts)

    def device_ms(self, fn, *a):
        """Device time of one ``fn(*a)`` in ms: every kernel and copy that
        the calls put on the card, summed from the profiler's device-side
        events, per call. A first session of ``DEVICE_REPS`` calls sizes the
        window: each of the ``DEVICE_SESSIONS`` sessions that follow holds
        enough back-to-back calls for about ``DEVICE_WINDOW_MS`` of device
        work, and opens on an idle device; their median. (A single
        three-call session read None once and ~3x its neighbours twice for a
        0.01-0.03 ms call.) Each session opens after one unrecorded warm-up
        call, between two fence kernels (``profile_device_records``). A
        session that records no device time, or another number of launches
        of one of the port's kernels than its wrapper counted in the
        session, is opened again after a pause, ``DEVICE_EMPTY_RETRIES``
        times at most in one reading, and counted in ``empty_sessions`` or
        ``short_sessions``. Past that the attempt that kept the most records
        counts its kernels by the records kept (each kernel's time per record
        times its launches, ``scaled_device_us``; counted in
        ``scaled_sessions``); where no attempt kept device time and a record
        of every launched kernel, the session is timed by CUDA events around
        the same calls queued behind a spin kernel (``queued_device_ms``,
        which also counts the device's time between kernels; counted in
        ``event_sessions``), and it raises only where that cannot hold the
        calls behind the spin either. (Late in a long process the profiler
        lost most records of some readings in every session on an H100, and
        every record of the DSB layer's kernel in all six sessions of one
        reading.) None off CUDA."""
        if self.device.type != "cuda":
            return None
        retried = 0

        def kept_share(records, launched) -> float:
            """How close to one record a launch: 1 when each was kept once,
            less as records are lost or borrowed from another window."""
            got = records_by_kernel(records)
            return min((min(got[k] / n, n / got[k]) if got[k] else 0.0
                        for k, n in launched.items() if n), default=1.0)

        def session(calls: int) -> float:
            nonlocal retried
            best = None                 # the attempt that kept the most records
            while True:
                _sync(self.device)
                records, launched, _ = profile_device_records(lambda: fn(*a), calls, self.device)
                total_us = sum(us for us, _ in records.values())
                missing = record_mismatch(launched, records)
                if total_us > 0 and not missing:
                    return total_us / calls / 1e3
                if total_us > 0 and (best is None or kept_share(records, launched) > best[0]):
                    best = (kept_share(records, launched), launched, records)
                retried += 1
                if total_us <= 0:
                    self.empty_sessions += 1
                else:
                    self.short_sessions += 1
                if retried <= DEVICE_EMPTY_RETRIES:
                    time.sleep(DEVICE_RETRY_PAUSE_S * 2 ** (retried - 1))
                    continue
                scaled = None if best is None else scaled_device_us(best[1], best[2])
                if scaled is not None:
                    self.scaled_sessions += 1
                    return scaled / calls / 1e3
                queued = queued_device_ms(lambda: fn(*a), calls, self.device)
                if queued is not None:
                    self.event_sessions += 1
                    return queued
                raise RuntimeError(
                    f"the profiler recorded no device time or not each kernel launch "
                    f"({missing}: records, launches) in {retried} sessions of "
                    f"{calls} calls on {self.device}, and the calls could not be "
                    f"queued behind a spin kernel to time them by CUDA events")

        per_call = session(DEVICE_REPS)
        calls = min(DEVICE_MAX_CALLS, max(DEVICE_REPS, math.ceil(DEVICE_WINDOW_MS / per_call)))
        return statistics.median(session(calls) for _ in range(DEVICE_SESSIONS))

    def measure(self, fn, *a, reps=None):
        """(last output, min wall seconds, device ms)."""
        out, wall = self.wall(fn, *a, reps=reps)
        return out, wall, self.device_ms(fn, *a)


def _ratio(num, den):
    return None if num is None or den is None else num / den


def frames(batch: int, device) -> torch.Tensor:
    """The bench's input frames, uniform in [0, 1), made from a seed."""
    x = np.random.RandomState(1).rand(batch, CFG.image_size, CFG.image_size, 3)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def make_model(device, seed: int = 0):
    """(params, state, specs): ``cnn.init`` from a seed, each conv weight
    rescaled to std 0.1 (population std, as ``jnp.std``) so that the
    *global* HAPM sort spreads groups across layers (isolates the kernel
    measurement from init-scale skew)."""
    params, state = cnn.init(seed, CFG, device=device)
    params = tree_map_with_path(
        lambda p, l: (l / torch.std(l, correction=0) * 0.1
                      if cnn.is_conv_weight(p, l) else l), params)
    return params, state, cnn.conv_group_specs(params, N_CU)


def hapm_prune(params, specs, target: float):
    """(pruned params, group masks) after one HAPM epoch at ``target``."""
    hcfg = HAPMConfig(target, 1)
    st = hapm_init(specs, hcfg)
    if target > 0:
        st = hapm_epoch_update(st, specs, params, hcfg)
    return apply_masks(params, hapm_element_masks(specs, st)), st.group_masks


def element_masks(specs, group_masks, device):
    """The element masks that ``group_masks`` expand to, on ``device``."""
    return tree_map(lambda m: m.to(device),
                    hapm_element_masks(specs, HAPMState(group_masks, 0, 0)))


def bench_level(params, state, specs, group_masks, target: float, device, *,
                x=None, timer=None) -> dict:
    """One row of the sweep: ``params`` are pruned by ``group_masks`` (a
    params-shaped tree of (num_groups,) {0,1} arrays). Binds every
    execution contract at this level, asserts the accounting and the
    parities, times each contract and returns the row."""
    cfg, device = CFG, torch.device(device)
    x = frames(4, device) if x is None else x
    batch = int(x.shape[0])
    timer = Timer(device) if timer is None else timer
    n_layers = len(cnn.conv_layer_order(cfg))
    accel = dataclasses.replace(BOARDS["zedboard_100mhz_72dsp"], n_cu=N_CU)
    qcfg = dataclasses.replace(cfg, quantized=True)

    # one bind per execution contract per sparsity level, reused for step
    # accounting AND timing (weights prepacked at bind time)
    bind = lambda **kw: cnn.bind_execution(
        params, cfg, spec=cnn.ExecSpec(n_cu=N_CU, **kw), specs=specs,
        group_masks=group_masks, device=device)
    execs = {
        # production: packed layout, implicit kernel, adaptive bm
        "implicit": bind(packed=True, implicit=True),
        # materializing contract: packed layout, patch matrix in memory, fixed bm
        "materializing": bind(packed=True, implicit=False, bm=128),
        # one (g, f_block) group per tile
        "pergroup": bind(packed=False, implicit=False, bm=128),
    }
    # kernel-only twins (no dense fallback): the isolated
    # implicit-vs-materializing data-movement comparison
    kernel_only = {
        kind: bind(packed=True, implicit=(kind == "implicit"),
                   bm="auto" if kind == "implicit" else 128, dense_fallback=2.0)
        for kind in ("implicit", "materializing")}
    # native int8 execution on the same plans, every layer on its kernel
    q_execs = {
        kind: bind(packed=True, implicit=(kind == "implicit"),
                   bm="auto" if kind == "implicit" else 128, quantized=True,
                   dense_fallback=2.0)
        for kind in ("implicit", "materializing")}

    # schedule-group accounting is layout- and kernel-independent and
    # equals the cycle model's DSB step count; the per-group layout's live
    # tiles ARE the live schedule steps
    gms = [np.asarray(cnn._get_path(group_masks, k)) for k in execs["implicit"].plans]
    live_groups = int(sum(m.sum() for m in gms))
    total_groups = sum(m.size for m in gms)
    for kind, e in {**execs, **{"ko_" + k: v for k, v in kernel_only.items()},
                    **{"q_" + k: v for k, v in q_execs.items()}}.items():
        assert e.schedule_step_counts() == (live_groups, total_groups), kind
    # the int8 execution dispatches the identical grid as the f32 path
    for kind in ("implicit", "materializing"):
        assert (q_execs[kind].step_counts(cfg, batch=1)
                == kernel_only[kind].step_counts(cfg, batch=1)), kind
    for keys, plan in execs["pergroup"].plans.items():
        gm_layer = np.asarray(cnn._get_path(group_masks, keys))
        assert int(plan.cnt.sum()) == int((gm_layer > 0).sum()), keys

    # dispatch accounting per image (the 4x4 tails round M-blocks up, so
    # per-batch counts are not linear in batch)
    steps = {k: e.step_counts(cfg, batch=1) for k, e in execs.items()}
    fallbacks = {k: sum(v is None for v in e.table.values()) for k, e in execs.items()}
    if target == 0.0:
        # density 1.0 falls back to the dense conv in every layer of every exec
        assert all(n == n_layers for n in fallbacks.values()), fallbacks

    (ref, _), t_dense, d_dense = timer.measure(
        lambda xx: cnn.apply(params, state, xx, cfg), x)
    walls, dev, errs, timed_graphs = {}, {}, {}, {}
    for kind, e in {**execs, **{"ko_" + k: v for k, v in kernel_only.items()}}.items():
        # identical all-fallback execs run the same dense convolutions:
        # timed once, so noise is not recorded as a speedup
        graph_key = "all-dense" if all(v is None for v in e.table.values()) else kind
        if graph_key not in timed_graphs:
            timed_graphs[graph_key] = timer.measure(
                lambda xx, ee=e: cnn.apply(params, state, xx, cfg, sparse=ee), x)
        (out, _), walls[kind], dev[kind] = timed_graphs[graph_key]
        errs[kind] = float((out - ref).abs().max())

    # the fixed-point execution is BIT-EXACT against the dense QAT forward,
    # provided the f32 reference itself is exact
    max_k = max(3 * 3 * cin for cin in (3,) + cfg.widths)
    assert f32_parity_is_exact(max_k), (
        f"bench config grew past the f32-exactness bound (K={max_k}): the f32 "
        "QAT reference would round while the int32 kernels stay exact")
    (qat_ref, _), _ = timer.wall(lambda xx: cnn.apply(params, state, xx, qcfg), x)
    q_outs = {}
    for kind, e in q_execs.items():
        (q_outs[kind], _), walls["q_" + kind], dev["q_" + kind] = timer.measure(
            lambda xx, ee=e: cnn.apply(params, state, xx, qcfg, sparse=ee), x)
    err_q_qat = max(float((o - qat_ref).abs().max()) for o in q_outs.values())
    assert err_q_qat == 0.0, f"int8 execution diverged from QAT codes at {target}: {err_q_qat}"
    assert bool(torch.equal(q_outs["implicit"], q_outs["materializing"]))
    err_q_f32 = float((q_outs["implicit"] - ref).abs().max())

    # end-to-end int8 activation streaming on the BN-folded tree, against
    # the same per-layer-quantized kernels with the requantize outside them
    folded_t = cnn.fold_batchnorm(params, state, cfg)
    fbind = lambda **kw: cnn.bind_execution(
        folded_t, cfg, spec=cnn.ExecSpec(n_cu=N_CU, quantized=True, folded=True,
                                         dense_fallback=2.0, **kw),
        specs=specs, group_masks=group_masks, device=device)
    s_execs = {kind: fbind(streamed=True, implicit=(kind == "implicit"),
                           bm="auto" if kind == "implicit" else 128)
               for kind in ("implicit", "materializing")}
    s_outs = {}
    for kind, e in s_execs.items():
        s_outs[kind], walls["s_" + kind], dev["s_" + kind] = timer.measure(
            lambda xx, ee=e: cnn.apply_folded(folded_t, xx, cfg, sparse=ee), x)
    wire_exec = fbind(implicit=True)
    wire_ref = cnn.apply_folded(folded_t, x, cfg, sparse=wire_exec, wire_quantize=True)
    err_s_wire = max(float((o - wire_ref).abs().max()) for o in s_outs.values())
    assert err_s_wire == 0.0, \
        f"streamed wire diverged from the requantized reference at {target}: {err_s_wire}"
    assert bool(torch.equal(s_outs["implicit"], s_outs["materializing"]))
    err_s_f32 = float((s_outs["implicit"] - ref).abs().max())

    # ---- dual-sided sparsity: activation-DSB on the streamed wire ----
    # the designated layer, fed a structured ReLU-sparse activation (every
    # other K-tile's channel block dead, plus ~30 % elementwise zeros) at a
    # batch sized so the kernel, not dispatch, dominates
    d_exec = fbind(streamed=True, implicit=True, activation_dsb=True)
    d_conv = d_exec.table[DSB_LAYER]
    s_conv = s_execs["implicit"].table[DSB_LAYER]
    dsb_stride, dsb_batch, dsb_cin = 2, 16, cfg.widths[1]
    cpk = d_conv.layout.implicit_geometry()["cpk"]
    drng = np.random.RandomState(7)
    xa = np.abs(drng.randn(dsb_batch, 8, 8, dsb_cin).astype(np.float32))
    xa[drng.rand(*xa.shape) < 0.3] = 0.0            # elementwise ReLU zeros
    for c0 in range(0, dsb_cin, 2 * cpk):
        xa[..., c0:c0 + cpk] = 0.0                  # every other K-tile dead
    xa_dense = np.abs(np.random.RandomState(8).randn(*xa.shape)).astype(np.float32) + 0.1
    xa, xa_dense = torch.from_numpy(xa).to(device), torch.from_numpy(xa_dense).to(device)
    y_dsb, dsb_stats = d_conv.skip_counts(xa, stride=dsb_stride)
    dsb_skip_frac = dsb_stats["skipped_steps"] / max(dsb_stats["live_steps"], 1)
    err_dsb = float((y_dsb.to(torch.int32)
                     - s_conv(xa, stride=dsb_stride).to(torch.int32)).abs().max()) \
        if dsb_stats["live_steps"] else 0.0
    assert err_dsb == 0.0, \
        f"activation-DSB diverged from the non-skip kernel at {target}: {err_dsb}"
    layer = lambda fn: (lambda xx: fn(xx, stride=dsb_stride))
    _, t_dsb, d_dsb = timer.measure(layer(d_conv), xa)
    _, t_noskip, d_noskip = timer.measure(layer(s_conv), xa)
    _, t_dsb_d, d_dsb_d = timer.measure(layer(d_conv), xa_dense)
    _, t_noskip_d, d_noskip_d = timer.measure(layer(s_conv), xa_dense)
    # end-to-end served skip on a ReLU-sparse frame (dead bottom half)
    x_relu = x.clone()
    x_relu[:, cfg.image_size // 2:] = 0.0
    dsb_e2e = d_exec.measure_dsb_skip(folded_t, x_relu, cfg)

    rep = simulate(params, state, cfg, accel)
    assert (rep.schedule_steps_live, rep.schedule_steps_total) == \
        (live_groups, total_groups), "cycle-model step accounting drifted"
    imp_rep = execs["implicit"].report(cfg, batch=1)     # per image
    imp_rep_b = execs["implicit"].report(cfg, batch=batch)
    mat_rep = execs["materializing"].report(cfg, batch=1)
    util_b1 = imp_rep["padded_mac_utilization"]
    util_b1_fixed = mat_rep["padded_mac_utilization"]
    hbm_imp = imp_rep["hbm_bytes_implicit"]
    hbm_mat = imp_rep["hbm_bytes_materialized"]
    q_hbm = imp_rep["hbm_bytes_implicit_int8"]
    q_hbm_mat = imp_rep["hbm_bytes_materialized_int8"]
    assert q_hbm == q_execs["implicit"].hbm_bytes(cfg, batch=1)
    s_hbm = imp_rep["hbm_bytes_streamed_int8"]
    assert s_hbm == s_execs["implicit"].hbm_bytes(cfg, batch=1)
    assert s_execs["implicit"].report(cfg, batch=1)["streamed"]
    row = {
        "target_group_sparsity": target,
        "executed_grid_steps": steps["materializing"][0],
        "dense_grid_steps": steps["materializing"][1],
        "grid_step_ratio": steps["materializing"][0] / steps["materializing"][1],
        "implicit_executed_grid_steps": steps["implicit"][0],
        "implicit_dense_grid_steps": steps["implicit"][1],
        "wall_sparse_ms": walls["implicit"] * 1e3,
        "wall_materializing_ms": walls["materializing"] * 1e3,
        "wall_pergroup_ms": walls["pergroup"] * 1e3,
        "wall_implicit_kernel_ms": walls["ko_implicit"] * 1e3,
        "wall_materializing_kernel_ms": walls["ko_materializing"] * 1e3,
        "implicit_vs_materializing_wallclock_speedup":
            walls["ko_materializing"] / walls["ko_implicit"],
        "hbm_bytes_moved_implicit": hbm_imp,
        "hbm_bytes_moved_materialized": hbm_mat,
        "hbm_bytes_ratio": hbm_imp / hbm_mat,
        "bm_effective": imp_rep["bm_effective"],
        "wall_quantized_ms": walls["q_implicit"] * 1e3,
        "wall_quantized_materializing_ms": walls["q_materializing"] * 1e3,
        "quantized_max_err_vs_qat": err_q_qat,
        "quantized_max_err_vs_f32": err_q_f32,
        "hbm_bytes_moved_quantized": q_hbm,
        "hbm_bytes_moved_quantized_materialized": q_hbm_mat,
        "quantized_hbm_ratio_vs_f32": q_hbm / hbm_imp,
        "wall_streamed_ms": walls["s_implicit"] * 1e3,
        "wall_streamed_materializing_ms": walls["s_materializing"] * 1e3,
        "streamed_max_err_vs_quantized": err_s_wire,
        "streamed_max_err_vs_f32": err_s_f32,
        "hbm_bytes_moved_streamed": s_hbm,
        "streamed_hbm_ratio_vs_f32": s_hbm / hbm_imp,
        "dsb_skip_frac": dsb_skip_frac,
        "dsb_skipped_steps": dsb_stats["skipped_steps"],
        "dsb_live_steps": dsb_stats["live_steps"],
        "wall_dsb_ms": t_dsb * 1e3,
        "wall_noskip_ms": t_noskip * 1e3,
        "dsb_kernel_speedup": t_noskip / t_dsb,
        "wall_dsb_dense_act_ms": t_dsb_d * 1e3,
        "wall_noskip_dense_act_ms": t_noskip_d * 1e3,
        "dsb_dense_act_ratio": t_noskip_d / t_dsb_d,
        "dsb_max_err_vs_noskip": err_dsb,
        "dsb_skip_frac_e2e": dsb_e2e["dsb_skip_frac"],
        "padded_mac_utilization": imp_rep_b["padded_mac_utilization"],
        "padded_mac_utilization_b1": util_b1,
        "padded_mac_utilization_b1_fixed_bm": util_b1_fixed,
        "adaptive_vs_fixed_b1_util": util_b1 / util_b1_fixed,
        "pergroup_executed_grid_steps": steps["pergroup"][0],
        "pergroup_dense_grid_steps": steps["pergroup"][1],
        "pergroup_grid_step_ratio": steps["pergroup"][0] / steps["pergroup"][1],
        "pergroup_mac_utilization": execs["pergroup"].mac_utilization(cfg, batch=batch),
        "schedule_steps_live": live_groups,
        "schedule_steps_total": total_groups,
        "schedule_step_ratio": live_groups / total_groups,
        "dsb_cycle_ratio": rep.dsb_cycle_ratio,
        "wall_dense_ms": t_dense * 1e3,
        "max_err_vs_dense": max(errs.values()),
        "packed_vs_pergroup_step_cut":
            steps["pergroup"][0] / max(steps["materializing"][0], 1),
        "packed_vs_pergroup_wallclock_speedup": walls["pergroup"] / walls["implicit"],
        "dense_fallback_layers": fallbacks["implicit"],
        "pergroup_dense_fallback_layers": fallbacks["pergroup"],
        # the same calls' device time (profiler): the wall ratios above
        # with the host's glue taken out
        "device_dense_ms": d_dense,
        "device_sparse_ms": dev["implicit"],
        "device_materializing_ms": dev["materializing"],
        "device_pergroup_ms": dev["pergroup"],
        "device_implicit_kernel_ms": dev["ko_implicit"],
        "device_materializing_kernel_ms": dev["ko_materializing"],
        "device_implicit_vs_materializing_speedup":
            _ratio(dev["ko_materializing"], dev["ko_implicit"]),
        "device_packed_vs_pergroup_speedup": _ratio(dev["pergroup"], dev["implicit"]),
        "device_quantized_ms": dev["q_implicit"],
        "device_quantized_materializing_ms": dev["q_materializing"],
        "device_streamed_ms": dev["s_implicit"],
        "device_streamed_materializing_ms": dev["s_materializing"],
        "device_dsb_ms": d_dsb,
        "device_noskip_ms": d_noskip,
        "device_dsb_kernel_speedup": _ratio(d_noskip, d_dsb),
        "device_dsb_dense_act_ms": d_dsb_d,
        "device_noskip_dense_act_ms": d_noskip_d,
        "device_dsb_dense_act_ratio": _ratio(d_noskip_d, d_dsb_d),
    }
    print(f"{target:>7.2f} {steps['implicit'][0]:>6}/{steps['implicit'][1]:<9} "
          f"{row['dsb_cycle_ratio']:>6.3f} {t_dense*1e3:>9.2f} "
          f"{walls['implicit']*1e3:>8.2f} {walls['materializing']*1e3:>7.2f} "
          f"{row['implicit_vs_materializing_wallclock_speedup']:>7.2f} "
          f"{row['hbm_bytes_ratio']:>6.2f} {walls['q_implicit']*1e3:>7.2f} "
          f"{row['quantized_hbm_ratio_vs_f32']:>8.2f} {walls['s_implicit']*1e3:>7.2f} "
          f"{row['streamed_hbm_ratio_vs_f32']:>8.2f} {util_b1:>8.3f} "
          f"{row['max_err_vs_dense']:>9.2e}")
    print(f"{'':>7} dual-sided: skip {dsb_skip_frac:.2f} "
          f"({dsb_stats['skipped_steps']}/{dsb_stats['live_steps']}), kernel "
          f"{t_noskip * 1e3:.2f} -> {t_dsb * 1e3:.2f} ms ({row['dsb_kernel_speedup']:.2f}x), "
          f"dense-act ratio {row['dsb_dense_act_ratio']:.2f}, e2e skip "
          f"{row['dsb_skip_frac_e2e']:.3f}, err {err_dsb:.1f}")
    assert row["max_err_vs_dense"] < 1e-4, f"sparse path diverged from dense at {target}"
    if target == 0.0:
        # the production execs are identical all-fallback graphs
        assert row["packed_vs_pergroup_wallclock_speedup"] == 1.0
        assert row["wall_sparse_ms"] == row["wall_materializing_ms"]
    return row


# the training binds: the reference's default trainable contract, and every
# layer bound (at 50 % the default keeps only layers whose every group is
# pruned, so only the second trains live weights through the kernels)
TRAIN_BINDS = {"sparse": {}, "all_bound": {"dense_fallback": 2.0}}
GRAD_PARITY_MAX = 1e-4


def train_step_columns(params, state, specs, group_masks, device, *, x=None,
                       timer=None) -> dict:
    """One fwd+bwd step on the 50 % model (``params`` pruned by
    ``group_masks``): dense library convolutions against each trainable
    bind of ``TRAIN_BINDS``, whose bound layers run the block-sparse kernels
    forward and backward, all beside the dense step in float64.

    The reference's columns come from the default bind (``sparse``), the
    ``*_all_bound`` ones from the bind with every layer on the kernels. Both
    keep the reference's asserts (gradients within 1e-4 of the dense f32
    step's, pruned gradients exactly 0, the loss within 1e-5); the
    all-bound gradients are also held to 1e-4 of the float64 step, and the
    ``*_vs_f64`` columns say which side of a parity gap errs."""
    cfg, device = CFG, torch.device(device)
    x = frames(4, device) if x is None else x
    timer = Timer(device) if timer is None else timer
    masks = element_masks(specs, group_masks, device)
    y = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.num_classes, int(x.shape[0]))).to(device)

    def loss(p, s, xx, sparse):
        logits, new_state = cnn.apply(apply_masks(p, masks), s, xx, cfg,
                                      train=True, sparse=sparse)
        return -torch.mean(F.log_softmax(logits, -1).gather(1, y[:, None])), new_state

    step = lambda sparse: (lambda p: value_and_grad(loss, p, state, x, sparse))
    flat = lambda g: {k: v.double() for k, v in tree_flatten_with_path(g)}
    max_err = lambda a, b: max(float((a[k] - b[k]).abs().max()) for k in b)
    to64 = lambda t: t.double()
    g64 = flat(value_and_grad(loss, tree_map(to64, params), tree_map(to64, state),
                              x.double(), None)[1])
    ((ld, _), gd), t_dense, d_dense = timer.measure(step(None), params, reps=TRAIN_REPS)
    gd = flat(gd)
    cols = {"train_step_dense_ms": t_dense * 1e3, "device_train_step_dense_ms": d_dense,
            "grad_dense_max_err_vs_f64": max_err(gd, g64)}
    print()
    for label, kw in TRAIN_BINDS.items():
        texec = cnn.bind_execution(params, cfg,
                                   spec=cnn.ExecSpec(n_cu=N_CU, trainable=True, **kw),
                                   specs=specs, group_masks=group_masks, device=device)
        ((ls, _), gs), t, d = timer.measure(step(texec), params, reps=TRAIN_REPS)
        gs = flat(gs)
        grad_err, grad_err64 = max_err(gs, gd), max_err(gs, g64)
        pruned_grad = max(float((gs[k] * (1 - m)).abs().max())
                          for k, m in tree_flatten_with_path(masks))
        bound = [k for k, v in texec.table.items() if v is not None]
        tag = "" if label == "sparse" else "_all_bound"
        cols.update({
            f"train_step_{label}_ms": t * 1e3,
            f"train_step_{label}_vs_dense_ratio": t / t_dense,
            f"grad_parity{tag}_max_err": grad_err,
            f"grad{tag}_max_err_vs_f64": grad_err64,
            f"pruned_group_grad{tag}_max": pruned_grad,
            f"train_layers_bound{tag}": len(bound),
            f"train_live_layers_bound{tag}": sum(int(texec.plans[k].cnt.sum()) > 0
                                                 for k in bound),
            f"device_train_step_{label}_ms": d,
            f"device_train_step_{label}_vs_dense_ratio": _ratio(d, d_dense),
        })
        print(f"train step @50% ({label}: {len(bound)} layers bound): dense "
              f"{t_dense*1e3:.2f} ms, sparse {t*1e3:.2f} ms ({t / t_dense:.2f}x), "
              f"grad parity {grad_err:.2e} (vs float64 {grad_err64:.2e}; dense "
              f"{cols['grad_dense_max_err_vs_f64']:.2e}), pruned-group grad {pruned_grad:.2e}")
        assert grad_err <= GRAD_PARITY_MAX, f"gradient parity broke ({label}): {grad_err}"
        if label == "all_bound":
            assert grad_err64 <= GRAD_PARITY_MAX, \
                f"gradient parity vs float64 broke ({label}): {grad_err64}"
        assert pruned_grad == 0.0, f"pruned groups must get exactly-zero gradients ({label})"
        assert abs(float(ld) - float(ls)) <= 1e-5, label
    return cols


def check_sweep(rows) -> None:
    """The reference's cross-row asserts: monotone sweep and the 50 %
    row's deterministic floors (the wall floors are the gate script's)."""
    # the executed grid and the priced FPGA schedule shrink monotonically
    # with group sparsity (HAPM masks are nested across targets)
    for a, b in zip(rows, rows[1:]):
        assert b["grid_step_ratio"] <= a["grid_step_ratio"] + 1e-9
        assert b["pergroup_grid_step_ratio"] <= a["pergroup_grid_step_ratio"] + 1e-9
        assert b["dsb_cycle_ratio"] <= a["dsb_cycle_ratio"] + 1e-9
    at50 = next(r for r in rows if r["target_group_sparsity"] == 0.5)
    assert at50["pergroup_grid_step_ratio"] <= 0.6, at50
    assert at50["packed_vs_pergroup_step_cut"] >= 4.0, at50
    assert at50["hbm_bytes_ratio"] <= 0.8, at50
    assert at50["adaptive_vs_fixed_b1_util"] >= 2.0, at50
    assert at50["quantized_hbm_ratio_vs_f32"] <= 0.5, at50
    assert all(r["quantized_max_err_vs_qat"] == 0.0 for r in rows)
    assert at50["quantized_max_err_vs_f32"] <= 1.0, at50
    assert at50["streamed_hbm_ratio_vs_f32"] <= 0.28, at50
    assert all(r["streamed_max_err_vs_quantized"] == 0.0 for r in rows)
    assert at50["streamed_max_err_vs_f32"] <= 1.0, at50
    assert all(r["dsb_max_err_vs_noskip"] == 0.0 for r in rows)
    assert at50["dsb_skip_frac"] >= 0.3, at50


def wall_floors(row) -> dict:
    """{wall ratio: {"ratio", "floor", "device_ratio", "verdict"}} of the
    reference's three wall-clock floors on one row."""
    device_key = {"implicit_vs_materializing_wallclock_speedup":
                  "device_implicit_vs_materializing_speedup",
                  "dsb_kernel_speedup": "device_dsb_kernel_speedup",
                  "dsb_dense_act_ratio": "device_dsb_dense_act_ratio"}
    return {k: {"ratio": row[k], "floor": floor, "device_ratio": row.get(device_key[k]),
                "verdict": "pass" if row[k] >= floor else "fail"}
            for k, floor in WALL_FLOORS.items()}


def environment(device: torch.device) -> dict:
    """What the numbers were taken on: device, card name and power limit
    (``nvidia-smi``), torch, CUDA and Python versions."""
    env = {"device": str(device), "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "device_kind": "cpu", "card": None}
    if device.type == "cuda":
        env["device_kind"] = torch.cuda.get_device_name(device)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
        lines = smi.stdout.strip().splitlines()
        env["card"] = lines[0] if lines else None
    return env


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="batch 2 instead of 4")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default: the GPU; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--out", default=OUT_JSON, help="where the JSON is written")
    return ap.parse_args(argv)


def run(args=None) -> dict:
    args = parse_args([]) if args is None else args
    fast = bool(args.fast)
    device = cnn.resolve_device(args.device)
    print("=" * 72)
    print("group-sparse CNN inference through the port's block-sparse kernels")
    print("=" * 72)
    batch = 2 if fast else 4
    params, state, specs = make_model(device)
    x = frames(batch, device)
    timer = Timer(device)
    rows, at50_model = [], None
    print(f"\n{'target':>7} {'impl exec/dense':>16} {'dsb':>6} "
          f"{'dense ms':>9} {'impl ms':>8} {'mat ms':>7} {'kern x':>7} "
          f"{'hbm x':>6} {'q ms':>7} {'q hbm x':>8} {'s ms':>7} "
          f"{'s hbm x':>8} {'util b1':>8} {'max err':>9}")
    for target in SWEEP:
        pruned, group_masks = hapm_prune(params, specs, target)
        if target == 0.5:
            at50_model = (pruned, group_masks)
        rows.append(bench_level(pruned, state, specs, group_masks, target, device,
                                x=x, timer=timer))
    check_sweep(rows)
    at50 = next(r for r in rows if r["target_group_sparsity"] == 0.5)
    pruned50, group_masks50 = at50_model
    at50.update(train_step_columns(pruned50, state, specs, group_masks50, device,
                                   x=x, timer=timer))
    at50["wall_floors"] = wall_floors(at50)
    for k, v in at50["wall_floors"].items():
        print(f"wall floor {k}: {v['ratio']:.3f} (floor {v['floor']}, device "
              f"{v['device_ratio']}) {v['verdict']}")

    out = {"config": {"n_cu": N_CU, "batch": batch, "fast": fast,
                      "stages": CFG.stages, "widths": CFG.widths,
                      "image_size": CFG.image_size, **environment(device),
                      "reps": REPS, "train_reps": TRAIN_REPS, "device_reps": DEVICE_REPS,
                      "device_sessions": DEVICE_SESSIONS, "device_window_ms": DEVICE_WINDOW_MS,
                      "device_empty_sessions": timer.empty_sessions,
                      "device_short_sessions": timer.short_sessions,
                      "device_scaled_sessions": timer.scaled_sessions,
                      "device_event_sessions": timer.event_sessions,
                      "timed": TIMED.format(reps=REPS, train_reps=TRAIN_REPS,
                                            device_reps=DEVICE_REPS,
                                            device_sessions=DEVICE_SESSIONS,
                                            device_window_ms=DEVICE_WINDOW_MS)},
           "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"\nwrote {args.out}")
    return out


if __name__ == "__main__":
    run(parse_args())
