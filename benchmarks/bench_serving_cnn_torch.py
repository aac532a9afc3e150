"""CNN serving on the PyTorch/CUDA port: the twin of
``benchmarks/bench_serving_cnn.py``. The persistent exec cache and bucketed
batching of :mod:`repro_torch.launch.serve_cnn`, against cold per-request
binds, on the reference's configurations, in the reference's phases and
order, with its column names and its hard asserts:

- ``cold_bind_p50_ms``: a fresh ``bind_execution`` plus a forward plus the
  logits copied to the host, per single-image request. PyTorch runs
  eagerly, so there is no per-request compile to pay (the reference's cold
  request also traces and jits; ``config.cold_path`` says so);
- per-bucket steady-state ``p50_ms`` / ``p99_ms`` / ``images_per_sec``
  through ``CnnServer`` after ``warmup()`` (every request a hit: asserted);
- ``bind_amortization_ratio`` = cold p50 / steady p50 at batch 1;
- bit-identical logits against a fresh bind at every bucket and through
  the pad-and-slice path of an off-bucket batch (``torch.equal``);
- the mask change (HAPM 0.5 -> 0.75) invalidating exactly the stale
  entries; the bucket batcher on a bursty virtual-clock trace;
- the streamed serving row (int8 wire, ``dense_fallback=2.0``), its logits
  bit-equal to a direct ``apply_folded``; per-image HBM accounting;
- the ``--chaos`` scenario: a streamed server under a seeded ``FaultPlan``,
  a virtual-clock trace with deadlines, an admission budget and a mid-trace
  mask update, every answer checked bit-exact against clean servers pinned
  to each ladder rung, then a snapshot and a warm restart.

Beside every timed column the twin puts a ``device_*`` one: the profiler's
device-side kernel and copy time per request (``Timer.device_ms`` of
``benchmarks/bench_sparse_cnn_torch.py``), its share of the wall p50
(``busy_share``) and the K1/K2 launches per request. They are ``None`` off
CUDA. The two amortization floors (≥ 5×, ratios of two host walls) are
recorded in ``amortization_floors`` with a verdict and enforced by
``benchmarks.check_sparse_regression_torch --require-serving``; the
resilience contract by ``--require-resilience``.

Run on the GPU (the default device), or on the CPU, where every kernel
wrapper runs its plain PyTorch version:

    PYTHONPATH=src python -m benchmarks.bench_serving_cnn_torch [--smoke]
    PYTHONPATH=src python -m benchmarks.bench_serving_cnn_torch --device cpu --smoke --out /tmp/s.json
    PYTHONPATH=src python -m benchmarks.bench_serving_cnn_torch --chaos --device cpu --smoke --out /tmp/s.json

It writes ``BENCH_serving_cnn_torch.json`` (or ``--out``), never the
reference's ``BENCH_serving_cnn.json``; ``--chaos`` runs the fault scenario
alone and merges its row into that file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from benchmarks.bench_sparse_cnn_torch import (DEVICE_REPS, DEVICE_SESSIONS,
                                               DEVICE_WINDOW_MS, Timer, environment)
from benchmarks.check_sparse_regression_torch import SERVING_AMORTIZATION_MIN
from repro_torch import kernels
from repro_torch.core import (HAPMConfig, apply_masks, hapm_element_masks,
                              hapm_epoch_update, hapm_init)
from repro_torch.launch.exec_cache import BucketBatcher
from repro_torch.launch.resilience import FaultPlan, ServePolicy
from repro_torch.launch.serve_cnn import CnnServer, simulate_trace
from repro_torch.models import cnn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_JSON = os.path.join(ROOT, "BENCH_serving_cnn_torch.json")
COLD_PATH = ("a cold request is a fresh cnn.bind_execution, then cnn.apply(train=False) "
             "through it, then the logits copied to the host; PyTorch runs eagerly, so "
             "it has no per-request trace and compile (the reference's cold request "
             "also runs jax.jit)")
TIMED = ("p50_ms / p99_ms / *cold*_ms: percentiles of blocking requests (frames in "
         "from the host, logits back on the host); on CUDA, CUDA events around each "
         "request with the stream idle before it and a synchronize at each stop. "
         "device_ms: torch.profiler's device-side kernel and copy time per request, "
         "the median of {sessions} sessions, each opened on an idle device over "
         "back-to-back requests (at least {reps}) that hold about {window_ms} ms of "
         "device work. busy_share = device_ms / p50_ms. launches: K1 and K2 CUDA "
         "launches per timed request.")
# the kernels a request launches (K3 and K4 are training's and the fixed point's)
SERVE_KERNELS = ("block_sparse_matmul", "implicit_block_sparse_conv")


def _pruned_model(cfg, n_cu, sparsity, seed=0, device=None):
    """(pruned params, BN state, group specs): ``cnn.init`` from a torch
    generator seeded with ``seed``, then one HAPM epoch at ``sparsity``."""
    params, state = cnn.init(torch.Generator().manual_seed(seed), cfg, device=device)
    specs = cnn.conv_group_specs(params, n_cu)
    hcfg = HAPMConfig(sparsity, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    return apply_masks(params, hapm_element_masks(specs, st)), state, specs


def _setup(args):
    """(fast, device, cfg, n_cu, buckets, reps, cold reps): the reference's
    two configurations (``--smoke`` / ``--fast``, else the full one)."""
    fast = bool(getattr(args, "fast", False) or getattr(args, "smoke", False))
    device = cnn.resolve_device(getattr(args, "device", None))
    if fast:
        cfg = cnn.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)
        return fast, device, cfg, 4, (1, 4, 8), 6, 2
    cfg = cnn.ResNetConfig(stages=(1, 1, 2), widths=(16, 32, 64), image_size=16)
    return fast, device, cfg, 12, (1, 8, 32), 8, 3


def _served_launches(before: dict, reps: int, device):
    """K1 and K2 launches per request since ``before``; None off CUDA."""
    if device.type != "cuda":
        return None
    after = kernels.launch_counts()
    return {k: (after[k] - before[k]) / reps for k in SERVE_KERNELS}


def run_chaos(args=None, timer=None) -> dict:
    """Fault-injection scenario: a streamed server under a seeded
    :class:`FaultPlan`, deadlines and an admission budget. Returns the
    ``chaos`` row; asserts the whole resilience contract on the way. The
    deadlines live on ``simulate_trace``'s virtual clock, so every counter
    of the row is the reference's on any device."""
    fast, device, cfg, n_cu, buckets, _, _ = _setup(args)
    timer = Timer(device) if timer is None else timer
    direct_reps = 6 if fast else 8
    print("-" * 72)
    print("chaos: fault injection + deadlines against the resilient server")
    print("-" * 72)
    h = cfg.image_size
    pruned, state, _ = _pruned_model(cfg, n_cu, sparsity=0.5, device=device)
    pruned75, _, _ = _pruned_model(cfg, n_cu, sparsity=0.75, device=device)
    spec = cnn.ExecSpec(n_cu=n_cu, quantized=True, folded=True,
                        streamed=True, dense_fallback=2.0)

    # deterministic schedule, four fault kinds (call indices 0-based):
    # - bind 0+1: transient failures — exhausts max_bind_retries=1 at the
    #   streamed rung, recorded downgrade to quantized;
    # - bind 2: injected bind latency at the quantized rung;
    # - output 1: a NaN logit — guardrail quarantines the quantized
    #   entry, recorded downgrade to f32;
    # - masks 1: a flipped group bit in the mid-trace mask update —
    #   fingerprint validation repairs it.
    faults = FaultPlan(seed=0, bind_fail_calls=(0, 1),
                       bind_delay_calls=(2,), bind_delay_s=0.001,
                       nonfinite_calls=(1,), mask_corrupt_calls=(1,))
    policy = ServePolicy(max_bind_retries=1, bind_backoff_s=0.001)
    server = CnnServer(pruned, state, cfg, spec=spec, buckets=buckets,
                       policy=policy, faults=faults, device=device)
    fpA = server.mask_fp                     # masks call 0: clean derive

    # -- direct phase: latency under faults, every answer verified ------
    rng = np.random.RandomState(0)
    direct, lats = [], []
    for i in range(direct_reps):
        x = rng.rand(1 + (i % buckets[1]), h, h, 3).astype(np.float32)
        y, (dt,) = timer.times(lambda: server.infer(x).cpu(), reps=1)
        lats.append(dt)
        direct.append((x, y.numpy(), server.last_request_level, server.mask_fp))
    lat = np.asarray(lats)
    direct_p50_ms = float(np.percentile(lat, 50)) * 1e3
    direct_p99_ms = float(np.percentile(lat, 99)) * 1e3
    # the last direct request again at the rung the faults left the server
    # on (no fault is scheduled past the direct phase's calls)
    direct_device_ms = timer.device_ms(lambda: server.infer(direct[-1][0]).cpu())
    print(f"[chaos] direct under faults: p50 {direct_p50_ms:.2f} ms  "
          f"p99 {direct_p99_ms:.2f} ms  level={server.level} "
          f"({server.stats()['rung']})  device {direct_device_ms} ms")

    # -- trace phase: deadlines + admission budget + mid-trace update ---
    mb = buckets[-1]
    budget = mb
    batcher = BucketBatcher(buckets, max_wait_s=0.004,
                            max_pending_images=budget)
    img_cache, served_fp = {}, {}

    def images_fn(rid, n):
        if rid not in img_cache:
            img_cache[rid] = np.random.RandomState(1000 + rid).rand(
                n, h, h, 3).astype(np.float32)
            served_fp[rid] = server.mask_fp   # fp at release == served fp
        return img_cache[rid]

    # segment A (t < 0.1) drains (gaps > max_wait) before the update event
    # at t=0.5; segment B serves the 0.75-pruned weights. Pairs that fill
    # the max bucket release (and serve) immediately; the near-simultaneous
    # overflow pair pushes past the admission budget (overload shed);
    # isolated requests wait out max_wait (0.004) > deadline (0.003) and are
    # deadline-shed at the flush.
    trace = [(0.000, mb - 2), (0.001, 2),           # fills -> served
             (0.010, mb - 2), (0.0101, 4),          # overload: budget + 2
             (0.080, mb - 2), (0.081, 2),           # fills -> served
             (1.000, mb - 2), (1.001, 2),           # served (new masks)
             (1.010, 1)]                            # isolated -> deadline
    events = [(0.5, lambda: server.update_masks(pruned75))]
    sim = simulate_trace(batcher, trace, lambda b: 0.002,
                         server=server, images_fn=images_fn,
                         deadline_s=0.003, events=events)
    assert server.resilience["mask_repairs"] >= 1, \
        "the corrupted mask update must be caught and repaired"
    assert sim["shed"] > 0, "the trace must exercise the shedding paths"
    assert sim["requests"] + sim["shed"] == sim["submitted"]
    shed_rate = sim["shed"] / sim["submitted"]
    print(f"[chaos] trace: {sim['requests']}/{sim['submitted']} served, "
          f"{sim['shed_deadline']} deadline-shed, "
          f"{sim['shed_overload']} overload-shed "
          f"(shed rate {shed_rate:.2f})")

    # -- zero wrong answers: bit-exact vs clean per-rung references -----
    # a degraded answer must equal what a fault-free server pinned to the
    # same ladder rung (and the same weights, on the same device) serves; a
    # multi-chunk request that degraded mid-way records its final rung, so
    # a match at any rung is accepted
    refs = {}

    def ref_for(fp, level):
        key = (fp, level)
        if key not in refs:
            weights = pruned if fp == fpA else pruned75
            s = CnnServer(weights, state, cfg, spec=spec, buckets=buckets, device=device)
            assert s.mask_fp == fp, "reference must reproduce the served fp"
            s.force_level(level)
            refs[key] = s
        return refs[key]

    def verify(x, y, level, fp):
        for lvl in [level] + [l for l in range(len(server.rungs)) if l != level]:
            if np.array_equal(ref_for(fp, lvl).infer(x).cpu().numpy(), y):
                return lvl
        return None

    wrong = at_recorded = 0
    checked = list(direct) + [
        (img_cache[rid], sim["outputs"][rid], sim["rungs"][rid], served_fp[rid])
        for rid in sorted(sim["outputs"])]
    for x, y, level, fp in checked:
        got = verify(x, y, level, fp)
        if got is None:
            wrong += 1
        elif got == level:
            at_recorded += 1
    assert wrong == 0, f"{wrong} wrong answer(s) under chaos"
    print(f"[chaos] {len(checked)} answers verified bit-exact vs clean "
          f"references ({at_recorded} at the recorded rung), 0 wrong")

    # -- every injected bind failure resolved: a retry absorbed it or a
    # ladder downgrade was recorded — none leaked to the caller
    res = server.resilience
    assert faults.injected["bind_fail"] == \
        res["bind_retries"] + res["bind_failures"], (faults.injected, res)
    assert res["downgrades"] >= res["bind_failures"]
    kinds = sorted(k for k, v in faults.injected.items() if v > 0)
    assert len(kinds) >= 3, kinds
    print(f"[chaos] fault kinds {kinds}: {faults.total_injected} injected, "
          f"{res['bind_retries']} retries, {res['bind_failures']} bind "
          f"failures -> {res['downgrades']} recorded downgrades")

    # -- crash recovery: snapshot -> warm restart skips mask derivation -
    with tempfile.TemporaryDirectory(prefix="cnn_server_snap_") as snap_dir:
        server.snapshot(snap_dir, step=1)
        warm = CnnServer(pruned75, state, cfg, spec=spec, buckets=buckets,
                         snapshot_dir=snap_dir, device=device)
    warm_ok = warm.mask_fp == server.mask_fp
    assert warm_ok, "warm restart must reproduce the snapshot fingerprint"
    x1 = rng.rand(1, h, h, 3).astype(np.float32)
    assert torch.equal(warm.infer(x1).cpu(), ref_for(server.mask_fp, 0).infer(x1).cpu())
    print("[chaos] snapshot -> warm restart: fingerprint + outputs match")

    return {
        "config": {"n_cu": n_cu, "buckets": list(buckets), "fast": fast,
                   "direct_reps": direct_reps, "budget_images": budget,
                   "deadline_s": 0.003},
        "fault_kinds": kinds,
        "faults_injected": dict(faults.injected),
        "direct_p50_ms": direct_p50_ms,
        "direct_p99_ms": direct_p99_ms,
        "direct_device_ms": direct_device_ms,
        "trace": {k: sim[k] for k in
                  ("submitted", "requests", "shed", "shed_deadline",
                   "shed_overload", "p50_s", "p99_s")},
        "shed_rate": shed_rate,
        "resilience": dict(res),
        "degrade_log": list(server.degrade_log),
        "answers_checked": len(checked),
        "answers_at_recorded_rung": at_recorded,
        "wrong_answers": wrong,
        "snapshot_warm_restart": warm_ok,
    }


def _merge_chaos(row: dict, out_path: str) -> None:
    """Write or refresh only the ``chaos`` key of the twin's JSON."""
    out = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            out = json.load(f)
    out["chaos"] = row
    _write(out, out_path)
    print(f"\nmerged chaos row into {out_path}")


def _write(out: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def amortization_floors(out: dict) -> dict:
    """{ratio: {"value", "floor", "pass"}} of the reference's two ≥ 5×
    bind-amortization asserts, which the twin records and the gate script
    enforces."""
    values = {"bind_amortization_ratio": out["bind_amortization_ratio"],
              "streamed.bind_amortization_ratio":
                  out["streamed"]["bind_amortization_ratio"]}
    return {k: {"value": v, "floor": SERVING_AMORTIZATION_MIN,
                "pass": v >= SERVING_AMORTIZATION_MIN} for k, v in values.items()}


def run(args=None) -> dict:
    args = parse_args([]) if args is None else args
    fast, device, cfg, n_cu, buckets, reps, cold_reps = _setup(args)
    print("=" * 72)
    print("CNN serving: persistent exec cache + bucketed batching")
    print("=" * 72)
    timer = Timer(device)
    pruned, state, _ = _pruned_model(cfg, n_cu, sparsity=0.5, device=device)
    spec = cnn.ExecSpec(n_cu=n_cu)          # production: packed/implicit/auto
    h = cfg.image_size
    rng = np.random.RandomState(0)
    x1 = rng.rand(1, h, h, 3).astype(np.float32)

    def fresh_forward(x):
        ex = cnn.bind_execution(pruned, cfg, spec=spec, device=device)
        return cnn.apply(pruned, state, torch.from_numpy(x).to(device), cfg,
                               train=False, sparse=ex)[0].cpu()

    # -- the kernels' build and the first call, outside every timed request
    kernel_build_s = None
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.load()
        kernel_build_s = _build.build_seconds      # this process's nvcc build
    t0 = time.perf_counter()
    fresh_forward(x1)
    first_request_s = time.perf_counter() - t0

    # -- cold path: what every request costs without the cache ----------
    _, cold = timer.times(fresh_forward, x1, reps=cold_reps)
    cold_p50 = float(np.percentile(cold, 50))
    print(f"[cold] bind+forward per request: {cold_p50 * 1e3:.1f} ms "
          f"(kernel build {kernel_build_s} s, first request {first_request_s:.2f} s)")

    # -- steady state through the cache ---------------------------------
    server = CnnServer(pruned, state, cfg, spec=spec, buckets=buckets, device=device)
    t0 = time.perf_counter()
    server.warmup()
    warmup_s = time.perf_counter() - t0
    binds_after_warmup = server.cache.binds
    assert binds_after_warmup == 1, "one bind must serve every bucket"
    server.cache.hits = server.cache.misses = 0    # steady-state window

    bucket_rows, steady_xs = [], {}
    for b in buckets:
        xb = rng.rand(b, h, h, 3).astype(np.float32)
        steady_xs[b] = xb
        request = lambda xx=xb: server.infer(xx).cpu()
        before = kernels.launch_counts()
        _, lat = timer.times(request, reps=reps)
        launches = _served_launches(before, reps, device)
        p50 = float(np.percentile(lat, 50))
        dev_ms = timer.device_ms(request)
        bucket_rows.append({
            "bucket": b,
            "p50_ms": p50 * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "images_per_sec": b / p50,
            "device_ms": dev_ms,
            "busy_share": None if dev_ms is None else dev_ms / (p50 * 1e3),
            "launches": launches,
        })
        print(f"[steady] bucket {b:>3}: p50 {bucket_rows[-1]['p50_ms']:.2f} ms"
              f"  p99 {bucket_rows[-1]['p99_ms']:.2f} ms"
              f"  {bucket_rows[-1]['images_per_sec']:.0f} img/s"
              f"  device {dev_ms} ms  launches {launches}")
    steady_hit_rate = server.cache.hit_rate
    assert steady_hit_rate == 1.0, server.cache.stats()
    steady_p50_b1 = bucket_rows[0]["p50_ms"] / 1e3
    amortization = cold_p50 / steady_p50_b1
    print(f"[amortize] cold {cold_p50 * 1e3:.1f} ms vs steady "
          f"{steady_p50_b1 * 1e3:.2f} ms -> {amortization:.0f}x")

    # -- exactness: cache output == fresh bind, at every bucket ---------
    for b in buckets:
        ref = fresh_forward(steady_xs[b])
        assert torch.equal(server.infer(steady_xs[b]).cpu(), ref), b
    # off-bucket batch: pad-to-bucket + slice must equal a fresh bind run at
    # the same padded shape (per-image independence: the padding rows
    # cannot touch the live rows)
    odd = buckets[-2] + 1                    # lands strictly inside a bucket
    bkt = next(b for b in buckets if b >= odd)
    x_odd = rng.rand(odd, h, h, 3).astype(np.float32)
    x_pad = np.concatenate([x_odd, np.zeros((bkt - odd, h, h, 3), np.float32)])
    ref = fresh_forward(x_pad)[:odd]
    assert torch.equal(server.infer(x_odd).cpu(), ref), odd
    print(f"[exact] bit-identical at buckets {list(buckets)} and batch "
          f"{odd} (padded to {bkt})")

    # -- mask change: invalidate exactly the stale binds, then re-steady
    pruned75, _, _ = _pruned_model(cfg, n_cu, sparsity=0.75, device=device)
    old_fp = server.mask_fp
    invalidated = server.update_masks(pruned75)
    assert server.mask_fp != old_fp
    assert invalidated == len(buckets), invalidated
    h0, m0, b0 = server.cache.hits, server.cache.misses, server.cache.binds
    server.infer(x1).cpu()                  # miss -> one rebind
    assert (server.cache.misses, server.cache.binds) == (m0 + 1, b0 + 1)
    server.infer(x1).cpu()                  # steady again
    assert server.cache.hits == h0 + 1
    mask_change = {"invalidated": invalidated, "rebinds": 1,
                   "old_fp": old_fp[:12], "new_fp": server.mask_fp[:12]}
    print(f"[masks] 0.5 -> 0.75 prune: {invalidated} entries invalidated, "
          f"1 rebind, steady state restored")

    # -- batcher under a bursty arrival trace (virtual clock) -----------
    svc = {r["bucket"]: r["p50_ms"] / 1e3 for r in bucket_rows}
    mean_gap = svc[buckets[0]] / 4           # arrivals faster than service
    trace = [(float(t), 1) for t in np.cumsum(rng.exponential(mean_gap, 64))]
    batcher = BucketBatcher(buckets, max_wait_s=4 * mean_gap)
    batch_sim = simulate_trace(batcher, trace, lambda b: svc[b])
    print(f"[batcher] {batch_sim}")

    # -- streamed serving: the end-to-end int8 wire through the cache ---
    # one contract, quantized + folded + streamed: the kernels requantize
    # in-epilogue and layers exchange Q3.4 codes; requests still submit f32
    # frames and receive f32 logits. dense_fallback=2.0 keeps every layer on
    # its int8 kernel: the row measures the streamed wire, not a dense conv.
    sspec = cnn.ExecSpec(n_cu=n_cu, quantized=True, folded=True,
                         streamed=True, dense_fallback=2.0)
    folded = cnn.fold_batchnorm(pruned, state, cfg)
    x1_dev = torch.from_numpy(x1).to(device)

    def fresh_streamed():
        tree = cnn.fold_batchnorm(pruned, state, cfg)
        ex = cnn.bind_execution(tree, cfg, spec=sspec, device=device)
        return cnn.apply_folded(tree, x1_dev, cfg, sparse=ex).cpu()

    _, cold_s = timer.times(fresh_streamed, reps=cold_reps)
    cold_s_p50 = float(np.percentile(cold_s, 50))
    server_s = CnnServer(pruned, state, cfg, spec=sspec, buckets=buckets, device=device)
    server_s.warmup()
    assert server_s.cache.binds == 1, "one streamed bind must serve every bucket"
    server_s.cache.hits = server_s.cache.misses = 0
    request_s = lambda: server_s.infer(x1).cpu()
    before = kernels.launch_counts()
    _, lats = timer.times(request_s, reps=reps)
    streamed_launches = _served_launches(before, reps, device)
    streamed_p50 = float(np.percentile(lats, 50))
    assert server_s.cache.hit_rate == 1.0, server_s.cache.stats()
    streamed_hit_rate = server_s.cache.hit_rate
    streamed_device_ms = timer.device_ms(request_s)
    streamed_amortization = cold_s_p50 / streamed_p50
    # served streamed logits == a direct streamed apply_folded, bitwise
    ex = cnn.bind_execution(folded, cfg, spec=sspec, group_masks=server_s.group_masks,
                            device=device)
    ref_s = cnn.apply_folded(folded, x1_dev, cfg, sparse=ex).cpu()
    assert torch.equal(server_s.infer(x1).cpu(), ref_s)
    streamed_row = {
        "cold_bind_p50_ms": cold_s_p50 * 1e3,
        "p50_ms": streamed_p50 * 1e3,
        "images_per_sec": 1.0 / streamed_p50,
        "bind_amortization_ratio": streamed_amortization,
        "steady_hit_rate": streamed_hit_rate,
        "hbm_bytes_streamed_int8": server_s.report(batch=1)["hbm_bytes_streamed_int8"],
        "device_ms": streamed_device_ms,
        "busy_share": (None if streamed_device_ms is None
                       else streamed_device_ms / (streamed_p50 * 1e3)),
        "launches": streamed_launches,
    }
    print(f"[streamed] cold {cold_s_p50 * 1e3:.1f} ms vs steady "
          f"{streamed_p50 * 1e3:.2f} ms -> {streamed_amortization:.0f}x "
          f"(int8 wire, bit-exact vs direct apply_folded; device "
          f"{streamed_device_ms} ms)")

    # -- per-image data movement of the served bind ---------------------
    rep = server.report(batch=1)
    hbm = {k: rep[k] for k in
           ("hbm_bytes", "hbm_bytes_implicit", "hbm_bytes_materialized",
            "hbm_bytes_implicit_int8", "hbm_bytes_materialized_int8",
            "hbm_bytes_streamed_int8",
            "hbm_bytes_ratio", "grid_step_ratio", "schedule_step_ratio")}

    out = {
        "config": {"n_cu": n_cu, "buckets": list(buckets), "fast": fast,
                   "stages": cfg.stages, "widths": cfg.widths,
                   "image_size": cfg.image_size, "sparsity": 0.5,
                   "spec": {f.name: getattr(spec, f.name)
                            for f in dataclasses.fields(spec)},
                   **environment(device), "reps": reps, "cold_reps": cold_reps,
                   "cold_path": COLD_PATH,
                   "timed": TIMED.format(sessions=DEVICE_SESSIONS, reps=DEVICE_REPS,
                                         window_ms=DEVICE_WINDOW_MS)},
        "kernel_build_s": kernel_build_s,
        "first_request_s": first_request_s,
        "cold_bind_p50_ms": cold_p50 * 1e3,
        "warmup_s": warmup_s,
        "binds_after_warmup": binds_after_warmup,
        "buckets": bucket_rows,
        "steady_hit_rate": steady_hit_rate,
        "bind_amortization_ratio": amortization,
        "bit_identical": True,
        "streamed": streamed_row,
        "mask_change": mask_change,
        "batcher": batch_sim,
        "hbm_per_image": hbm,
        "cache": server.cache.stats(),
    }
    out["amortization_floors"] = amortization_floors(out)
    for k, v in out["amortization_floors"].items():
        print(f"amortization floor {k}: {v['value']:.2f} (floor {v['floor']}) "
              f"{'pass' if v['pass'] else 'fail'}")
    out["chaos"] = run_chaos(args, timer)
    out["config"]["device_empty_sessions"] = timer.empty_sessions
    _write(out, args.out)
    print(f"\nwrote {args.out}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=False,
                    help="the reference's small configuration")
    ap.add_argument("--fast", action="store_true", help="the same as --smoke")
    ap.add_argument("--chaos", action="store_true",
                    help="run only the fault-injection scenario and merge its row "
                         "into the JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (default: the GPU, an error without "
                         "one; 'cpu' runs the kernels' plain PyTorch versions)")
    ap.add_argument("--out", default=OUT_JSON, help="where the JSON is written")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.chaos:
        _merge_chaos(run_chaos(args), args.out)
    else:
        run(args)


if __name__ == "__main__":
    main()
