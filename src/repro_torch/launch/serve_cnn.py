"""CNN serving: HAPM block-sparse inference behind the persistent
exec cache.

CNN serving sees arbitrary request batch sizes and (between HAPM epochs) a
*moving* sparsity pattern. The :class:`CnnServer` absorbs both:

- requests of any size are chunked/padded onto the bucket grid
  (:func:`repro_torch.launch.exec_cache.bucket_for`), so only
  ``len(buckets)`` batch shapes ever reach the kernels — and because
  eval-mode inference is per-image independent, sliced outputs are
  bit-identical to a fresh unbucketed bind;
- every bucket's entry shares one :class:`~repro_torch.models.cnn.ExecSpec`
  bind (plan construction + int8 weight prepacking paid once), looked up
  in an :class:`~repro_torch.launch.exec_cache.ExecCache` keyed on
  ``(arch, sparsity fingerprint, spec, bucket)``. There is no compile step
  per entry — PyTorch runs eagerly, the entry's callable is a plain
  closure — but the key is kept, so cache accounting equals the JAX
  package's on the same request sequence;
- :meth:`CnnServer.update_masks` installs post-HAPM-epoch weights: the
  mask fingerprint is recomputed host-side (no bind) and exactly the
  stale cache entries are invalidated — steady-state serving between
  epochs never re-plans or re-packs.

The server runs on the GPU by default (``device=None`` → CUDA; raises
without one); ``device="cpu"`` serves through the kernels' plain PyTorch
versions explicitly. Requests may be numpy arrays or tensors on any
device; answers are tensors on the serving device.

**Resilience** (:mod:`repro_torch.launch.resilience`): a failed or
injected-faulty bind retries with bounded exponential backoff, then walks
the graceful-degradation ladder (``streamed → quantized → f32 → dense
library conv``) — each rung is bit-exact *for the spec it ran under*, so a
degraded answer is never a wrong answer. Non-finite outputs quarantine
the offending cache entry and rebind one rung down; if even the dense
rung is non-finite the server raises instead of answering. A CUDA launch
error is not a bind error: it propagates. Requests carry deadlines
(``infer(deadline_s=...)``) and are shed — counted, never hung — when the
deadline cannot be met; admission control sheds or downgrades oversized
requests. :meth:`CnnServer.snapshot` persists the mask/fingerprint state
through :mod:`repro_torch.train.checkpoint` so a restarted server
(``snapshot_dir=``) warm-starts without re-deriving HAPM masks.

``python -m repro_torch.launch.serve_cnn --smoke`` runs the server
standalone (``--device cpu`` to run it without a GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.masks import tree_leaves, tree_map
from ..models import cnn
from ..sparse.conv_plan import mask_fingerprint
from .exec_cache import (DEFAULT_BUCKETS, BucketBatcher, CacheEntry,
                         ExecCache, arch_fingerprint, bucket_for)
from .resilience import (DENSE_RUNG, DeadlineExceeded, FaultPlan,
                         NonFiniteOutputError, OverloadError, ServePolicy,
                         degradation_ladder, retry_bind, rung_name)

logger = logging.getLogger(__name__)

SNAPSHOT_KIND = "cnn_server_snapshot"
_MASK_PREFIX = "masks|"          # checkpoint._flatten path join of {"masks": ...}

def _fresh_resilience_counters() -> Dict[str, int]:
    return {"bind_retries": 0, "bind_failures": 0, "downgrades": 0,
            "nonfinite_caught": 0, "mask_repairs": 0, "shed_overload": 0,
            "overload_downgrades": 0, "deadline_timeouts": 0,
            "promotions": 0}


class CnnServer:
    """Serve ``cnn.apply`` / ``cnn.apply_folded`` through the exec cache.

    ``spec`` fixes the execution contract for every request this server
    answers (packed/implicit/quantized/folded/streamed/bm — one server,
    one contract; run two servers over one shared :class:`ExecCache` for
    mixed fleets). The run config's ``quantized`` flag follows the spec,
    so a quantized bind serves a quantized forward without the caller
    threading two switches. A ``streamed`` spec (quantized + folded)
    serves the end-to-end int8 wire: ``apply_folded`` detects the
    streamed exec and chains the layers on Q3.4 codes — requests still
    submit f32 frames and receive f32 logits.

    ``policy`` (a :class:`~repro_torch.launch.resilience.ServePolicy`) controls
    the recovery machinery; ``faults`` installs a
    :class:`~repro_torch.launch.resilience.FaultPlan` whose hooks fire inside
    the real bind/forward/mask-update paths (chaos testing);
    ``device`` is where the server's weights, binds and answers live (the
    GPU unless ``"cpu"`` is asked for). The server's
    current ladder position is ``stats()["rung"]``; it degrades stickily
    on faults and resets on :meth:`update_masks`. With
    ``policy.promote_after_clean = N`` the stickiness is latency-aware
    instead of permanent: after ``N`` consecutive requests served
    entirely clean at a degraded rung, the server walks back *up* one
    rung (counted in ``resilience["promotions"]``) — a transient fault
    no longer costs the fast contract forever, and a persistent fault
    just re-degrades and restarts the streak.
    """

    def __init__(self, params, state, cfg: cnn.ResNetConfig, *,
                 spec: Optional[cnn.ExecSpec] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 cache: Optional[ExecCache] = None,
                 cache_capacity: int = 16,
                 policy: Optional[ServePolicy] = None,
                 faults: Optional[FaultPlan] = None,
                 snapshot_dir: Optional[str] = None,
                 device=None):
        self.device = cnn.resolve_device(device)
        self.spec = cnn.ExecSpec() if spec is None else spec
        self.policy = ServePolicy() if policy is None else policy
        self.faults = faults
        self.buckets = tuple(sorted(buckets))
        self.cache = ExecCache(cache_capacity) if cache is None else cache
        self.cfg = cfg
        self.run_cfg = (cfg if cfg.quantized == self.spec.quantized else
                        dataclasses.replace(cfg, quantized=self.spec.quantized))
        self._rungs = degradation_ladder(self.spec)
        self._level = 0
        self._clean_streak = 0
        self._svc_ema: Dict[int, float] = {}
        self.resilience = _fresh_resilience_counters()
        self.degrade_log: List[str] = []
        self.last_request_level = 0
        self._install(params, state, snapshot_dir=snapshot_dir)

    # -- model / fingerprint state ------------------------------------
    def _install(self, params, state, snapshot_dir: Optional[str] = None
                 ) -> None:
        # tensors already on the serving device are kept as they are (so
        # update_masks can tell a no-op by identity); others are copied over
        to_dev = lambda t: t.to(self.device)
        params, state = tree_map(to_dev, params), tree_map(to_dev, state)
        self.params, self.state = params, state
        if self.spec.folded:
            self._tree = cnn.fold_batchnorm(params, state, self.cfg)
            conv_tree = {k: v for k, v in self._tree.items() if k != "fc"}
            derive = lambda: cnn.derive_group_masks(conv_tree, self.spec.n_cu)
        else:
            self._tree = params
            derive = lambda: cnn.derive_group_masks(
                params, self.spec.n_cu, quantized=self.spec.quantized)
        self.arch_fp = arch_fingerprint(self.cfg, params)
        masks = fp = None
        if snapshot_dir is not None:
            loaded = self._snapshot_masks(snapshot_dir)
            if loaded is not None:
                masks, fp = loaded
        if masks is None:
            masks = derive()
            fp = mask_fingerprint(masks)
            if self.faults is not None:
                # the fault hook models corruption *after* derivation (a
                # flipped bit in the mask buffer / a torn update); the
                # fingerprint cross-check is the real detection path
                seen = self.faults.on_masks(masks)
                if seen is not masks and mask_fingerprint(seen) != fp:
                    if self.policy.validate_masks:
                        self.resilience["mask_repairs"] += 1
                        logger.warning(
                            "mask update failed fingerprint validation — "
                            "repaired from the freshly-derived pattern")
                    else:
                        masks, fp = seen, mask_fingerprint(seen)
        self.group_masks = masks
        self.mask_fp = fp
        self._rung_masks: Dict[bool, tuple] = {}

    @property
    def bind_key(self) -> tuple:
        return (self.arch_fp, self.mask_fp, self.spec)

    @property
    def rungs(self) -> tuple:
        """The degradation ladder (rung 0 = the requested spec, last =
        ``None``, the dense library-conv fallback)."""
        return self._rungs

    @property
    def level(self) -> int:
        """Current (sticky) ladder position new requests start from."""
        return self._level

    def force_level(self, level: int) -> None:
        """Pin the ladder position — for tests and for building per-rung
        reference servers (the chaos bench compares degraded answers
        against a clean server forced to the same rung)."""
        if not 0 <= level < len(self._rungs):
            raise ValueError(
                f"level must be in [0, {len(self._rungs) - 1}], got {level}")
        self._level = level
        self._clean_streak = 0

    def update_masks(self, params, state=None) -> int:
        """Install new weights (a HAPM epoch pruned more groups, or a
        finetune step moved values) and invalidate exactly the stale
        cache entries. The sparsity fingerprint is recomputed host-side —
        no bind happens until the next request. Entries survive only when
        nothing changed at all (same arrays, same pattern): a bind is
        pinned to its exact weight arrays, so same-pattern-new-values
        still rebinds. Returns the number of entries invalidated.

        Also resets the resilience state: the degradation level returns
        to rung 0 and quarantines are lifted — new weights produce new
        binds, so a previously-poisoned fingerprint is unreachable (and
        if the fault persists, the guardrail re-catches it).

        The no-op check compares the *installed* ``params``/``state``
        leaves, not the derived tree: on a folded server ``_install``
        re-runs ``fold_batchnorm``, which allocates fresh arrays every
        call, so an identity comparison on the folded tree would read
        every no-op update as a change and flush the whole cache."""
        old_leaves = tree_leaves((self.params, self.state))
        self._install(params, self.state if state is None else state)
        new_leaves = tree_leaves((self.params, self.state))
        unchanged = (len(old_leaves) == len(new_leaves) and
                     all(a is b for a, b in zip(old_leaves, new_leaves)))
        self._level = 0
        self._clean_streak = 0
        self.cache.clear_quarantine()
        return self.cache.invalidate(
            self.arch_fp, keep_mask_fp=self.mask_fp if unchanged else None)

    # -- snapshot / warm restore --------------------------------------
    def snapshot(self, ckpt_dir: str, step: int = 0) -> str:
        """Persist the bind-key state (group masks + fingerprints)
        through :mod:`repro_torch.train.checkpoint` (atomic, manifested;
        the JAX package's file format). A restarted server passes the
        directory as ``snapshot_dir`` and warms its exec cache without
        re-deriving HAPM masks — the host-side ``group_scores`` sweep over
        every conv layer. Returns the checkpoint path."""
        from ..train import checkpoint as CKPT
        tree = {"masks": {"/".join(k): np.asarray(v)
                          for k, v in self.group_masks.items()}}
        return CKPT.save(ckpt_dir, step, tree, extra_meta={
            "kind": SNAPSHOT_KIND, "arch_fp": self.arch_fp,
            "mask_fp": self.mask_fp, "spec": repr(self.spec)})

    def _snapshot_masks(self, snapshot_dir: str) -> Optional[tuple]:
        """Load (masks, fingerprint) from a :meth:`snapshot` directory,
        or ``None`` (with a warning) when there is no usable snapshot —
        missing, for a different arch/spec, or failing the fingerprint
        integrity check (corruption is repaired by falling back to fresh
        derivation, never served)."""
        from ..train import checkpoint as CKPT
        try:
            flat, meta = CKPT.load_flat(snapshot_dir)
        except FileNotFoundError:
            warnings.warn(f"no server snapshot under {snapshot_dir!r} — "
                          "deriving masks fresh")
            return None
        if (meta.get("kind") != SNAPSHOT_KIND
                or meta.get("arch_fp") != self.arch_fp
                or meta.get("spec") != repr(self.spec)):
            warnings.warn(
                f"snapshot under {snapshot_dir!r} does not match this "
                "server (kind/arch/spec) — deriving masks fresh")
            return None
        masks = {tuple(k[len(_MASK_PREFIX):].split("/")):
                 np.asarray(v, np.float32)
                 for k, v in flat.items() if k.startswith(_MASK_PREFIX)}
        fp = mask_fingerprint(masks)
        if self.policy.validate_masks and fp != meta.get("mask_fp"):
            warnings.warn(
                f"snapshot under {snapshot_dir!r} failed its mask-"
                "fingerprint integrity check (corrupt or stale) — "
                "deriving masks fresh")
            self.resilience["mask_repairs"] += 1
            return None
        return masks, fp

    # -- exec plumbing ------------------------------------------
    def _masks_for(self, rung: cnn.ExecSpec) -> tuple:
        """(group masks, fingerprint) for a ladder rung. Folded rungs
        derive masks from the folded tree (quantization-independent), so
        every folded rung shares the install-time masks; a plain rung
        whose ``quantized`` differs from the base spec re-derives (the
        Q2.5 zero-code rule can mark more groups skippable than exact-
        zero f32) and memoizes until the next mask update."""
        if rung.folded or rung.quantized == self.spec.quantized:
            return self.group_masks, self.mask_fp
        hit = self._rung_masks.get(rung.quantized)
        if hit is None:
            masks = cnn.derive_group_masks(self.params, self.spec.n_cu,
                                           quantized=rung.quantized)
            hit = (masks, mask_fingerprint(masks))
            self._rung_masks[rung.quantized] = hit
        return hit

    def _key_for(self, rung: Optional[cnn.ExecSpec]) -> tuple:
        if rung is None:
            return (self.arch_fp, self.mask_fp, DENSE_RUNG)
        return (self.arch_fp, self._masks_for(rung)[1], rung)

    def _run_cfg_for(self, rung: Optional[cnn.ExecSpec]):
        q = False if rung is None else rung.quantized
        return (self.cfg if self.cfg.quantized == q else
                dataclasses.replace(self.cfg, quantized=q))

    def _bind_rung(self, rung: cnn.ExecSpec) -> Any:
        """Bind (or reuse) the exec of one ladder rung, with the fault
        hook and the bounded-retry/backoff policy applied."""
        masks, fp = self._masks_for(rung)
        bind_key = (self.arch_fp, fp, rung)
        exec_ = self.cache.shared_exec(bind_key)
        if exec_ is not None:
            return exec_
        pol = self.policy

        def do_bind():
            if self.faults is not None:
                self.faults.on_bind(rung)
            return cnn.bind_execution(self._tree, self.cfg, spec=rung,
                                      group_masks=masks, device=self.device)

        def on_retry(attempt):
            self.resilience["bind_retries"] += 1
            logger.warning("bind of %s rung failed (attempt %d) — retrying "
                           "with backoff", rung_name(rung), attempt + 1)

        exec_ = retry_bind(do_bind, retries=pol.max_bind_retries,
                           backoff_s=pol.bind_backoff_s,
                           factor=pol.bind_backoff_factor, on_retry=on_retry)
        self.cache.binds += 1
        return exec_

    def _bind(self) -> Any:
        return self._bind_rung(self._rungs[0])

    def _dense_fn(self) -> Callable:
        """The bottom rung: plain library-conv execution (f32, no sparse
        exec, nothing to bind — it cannot fail the way a bind can)."""
        tree, state = self._tree, self.state
        run_cfg = self._run_cfg_for(None)
        if self.spec.folded:
            return lambda x: cnn.apply_folded(tree, x, run_cfg)
        return lambda x: cnn.apply(tree, state, x, run_cfg, train=False)[0]

    def _entry_for(self, rung: Optional[cnn.ExecSpec],
                   bucket: int) -> CacheEntry:
        key = self._key_for(rung) + (bucket,)
        entry = self.cache.get(key)
        if entry is not None:
            return entry
        if rung is None:
            return self.cache.put(key, CacheEntry(
                exec_=None, fn=self._dense_fn(), bucket=bucket))
        exec_ = self._bind_rung(rung)
        tree, state = self._tree, self.state
        run_cfg = self._run_cfg_for(rung)
        if rung.folded:
            fn = lambda x, ee=exec_: cnn.apply_folded(
                tree, x, run_cfg, sparse=ee)
        else:
            fn = lambda x, ee=exec_: cnn.apply(
                tree, state, x, run_cfg, train=False, sparse=ee)[0]
        return self.cache.put(key, CacheEntry(exec_=exec_, fn=fn,
                                              bucket=bucket))

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Bind once and run every bucket once (the bind, and the kernels'
        build on the first CUDA call, are paid here, not on a live
        request) — at the current ladder rung."""
        h = self.cfg.image_size
        rung = self._rungs[self._level]
        for b in (self.buckets if buckets is None else buckets):
            entry = self._entry_for(rung, b)
            y = entry.fn(torch.zeros((b, h, h, self.cfg.in_channels),
                                     dtype=torch.float32, device=self.device))
            y.cpu()                      # wait for the device

    # -- request path --------------------------------------------------
    def _validate_images(self, images) -> None:
        h, c = self.cfg.image_size, self.cfg.in_channels
        shape = tuple(images.shape)
        if images.ndim != 4 or shape[1:] != (h, h, c):
            raise ValueError(
                "CnnServer.infer expects images shaped (B, H, W, C) = "
                f"(B, {h}, {h}, {c}) for this config; got shape {shape} — "
                "fix the request instead of letting the bound exec "
                "surface a shape error from inside a kernel")
        if not images.dtype.is_floating_point:
            raise ValueError(
                "CnnServer.infer expects floating-point frames in [0, 1] "
                f"(the Q3.4 ingest quantizes them); got dtype "
                f"{images.dtype} — convert before submitting")

    def _degrade(self, level: int, why: str) -> int:
        new = level + 1
        step = (f"{rung_name(self._rungs[level])} -> "
                f"{rung_name(self._rungs[new])}: {why}")
        self.resilience["downgrades"] += 1
        self._clean_streak = 0           # promotion must re-earn the rung
        self.degrade_log.append(step)
        del self.degrade_log[:-50]
        logger.warning("degradation ladder: %s", step)
        if new > self._level:
            self._level = new            # sticky: later requests start here
        return new

    def _note_clean_request(self, start_level: int, end_level: int,
                            downgraded: bool) -> None:
        """Latency-aware ladder promotion (``policy.promote_after_clean``):
        a request that ran entirely at its sticky starting rung — no
        mid-request degradation, no overload downgrade — extends the
        clean streak; ``N`` in a row at a degraded rung walk the sticky
        level back *up* one rung. Any degradation resets the streak (see
        :meth:`_degrade`), so a persistent fault oscillates at most once
        per ``N`` requests instead of pinning the fast contract forever."""
        pol = self.policy
        if pol.promote_after_clean is None:
            return
        if downgraded or end_level != start_level or self._level == 0:
            if downgraded:
                self._clean_streak = 0
            return
        self._clean_streak += 1
        if self._clean_streak < pol.promote_after_clean:
            return
        old = self._level
        self._level = old - 1
        self._clean_streak = 0
        self.resilience["promotions"] += 1
        step = (f"{rung_name(self._rungs[old])} -> "
                f"{rung_name(self._rungs[self._level])}: promoted after "
                f"{pol.promote_after_clean} consecutive clean request(s)")
        self.degrade_log.append(step)
        del self.degrade_log[:-50]
        logger.info("degradation ladder: %s", step)

    def _run_chunk(self, x, bucket: int, level: int):
        """One padded chunk through the ladder: bind (with retries) at
        the current rung, run, guard the output; on failure quarantine /
        step down and re-run. Returns ``(logits, level)`` — the rung the
        answer actually ran under (bit-exact for that rung's spec)."""
        pol = self.policy
        while True:
            rung = self._rungs[level]
            if rung is not None and self.cache.is_quarantined(
                    self._key_for(rung)):
                level = self._degrade(level, "bind is quarantined")
                continue
            try:
                entry = self._entry_for(rung, bucket)
            except cnn.BindError as e:
                self.resilience["bind_failures"] += 1
                if not (pol.allow_degrade and level + 1 < len(self._rungs)):
                    raise
                level = self._degrade(level, f"bind failed after retries "
                                             f"({type(e).__name__})")
                continue
            y = entry.fn(x)
            if self.faults is not None:
                y = self.faults.on_output(y)
            if pol.check_finite and not bool(torch.isfinite(y).all()):
                self.resilience["nonfinite_caught"] += 1
                if rung is not None:
                    self.cache.quarantine(self._key_for(rung))
                if not (pol.allow_degrade and level + 1 < len(self._rungs)):
                    raise NonFiniteOutputError(
                        f"non-finite outputs at the {rung_name(rung)} rung "
                        "with nothing left to degrade to — refusing to "
                        "return a wrong answer")
                level = self._degrade(level, "non-finite output (entry "
                                             "quarantined)")
                continue
            return y, level

    def infer(self, images, *, deadline_s: Optional[float] = None
              ) -> torch.Tensor:
        """Logits for ``images`` (B, H, W, 3), any B: chunked into
        max-bucket pieces, each padded up to its bucket and sliced back —
        bit-identical to an unbucketed forward (per-image independence)
        *at the rung the request ran under* (``last_request_level``).

        ``deadline_s`` (seconds from now; default
        ``policy.default_deadline_s``) sheds the request — raises
        :class:`DeadlineExceeded`, counted in
        ``stats()["resilience"]["deadline_timeouts"]`` — when the
        remaining work cannot finish in time (measured per-bucket
        service-time EMA), instead of running forwards past the
        deadline. Oversized requests hit admission control first
        (``policy.max_request_images``): shed with
        :class:`OverloadError` or served one ladder rung down, per
        ``policy.overload_action``."""
        images = torch.as_tensor(images)
        self._validate_images(images)
        images = images.to(self.device)
        pol = self.policy
        if deadline_s is None:
            deadline_s = pol.default_deadline_s
        n = images.shape[0]
        if n == 0:
            # the chunk loop never runs — answer the degenerate request
            # with an empty logits array instead of IndexError on out[0]
            return torch.zeros((0, self.cfg.num_classes), dtype=torch.float32,
                               device=self.device)
        level = self._level
        start_level = level
        overload_downgraded = False
        if pol.max_request_images is not None and n > pol.max_request_images:
            if pol.overload_action == "shed":
                self.resilience["shed_overload"] += 1
                raise OverloadError(
                    f"request of {n} image(s) exceeds the admission budget "
                    f"{pol.max_request_images} — shed "
                    "(overload_action='shed')")
            if level + 1 < len(self._rungs):
                level += 1               # degrade this request only
                overload_downgraded = True
                self.resilience["overload_downgrades"] += 1
                logger.warning(
                    "oversized request (%d > %d images) served one rung "
                    "down at %s", n, pol.max_request_images,
                    rung_name(self._rungs[level]))
        t0 = time.monotonic()
        out = []
        max_b = self.buckets[-1]
        for lo in range(0, n, max_b):
            chunk = images[lo:lo + max_b]
            bucket = bucket_for(chunk.shape[0], self.buckets)
            if deadline_s is not None:
                elapsed = time.monotonic() - t0
                if elapsed + self._svc_ema.get(bucket, 0.0) > deadline_s:
                    self.resilience["deadline_timeouts"] += 1
                    raise DeadlineExceeded(
                        f"{n - lo} of {n} image(s) unserved at "
                        f"{elapsed:.3f}s of a {deadline_s}s deadline — "
                        "request shed, partial work discarded")
            if chunk.shape[0] < bucket:
                pad = torch.zeros((bucket - chunk.shape[0],) + tuple(chunk.shape[1:]),
                                  dtype=chunk.dtype, device=chunk.device)
                x = torch.cat([chunk, pad])
            else:
                x = chunk
            t1 = time.monotonic()
            y, level = self._run_chunk(x, bucket, level)
            dt = time.monotonic() - t1
            ema = self._svc_ema.get(bucket)
            self._svc_ema[bucket] = dt if ema is None else 0.7 * ema + 0.3 * dt
            out.append(y[:chunk.shape[0]])
        self.last_request_level = level
        self._note_clean_request(start_level, level, overload_downgraded)
        return out[0] if len(out) == 1 else torch.cat(out)

    def report(self, batch: int = 1, **kw) -> Dict[str, Any]:
        """The bind's :meth:`SparseConvExec.report` accounting (per-image
        HBM bytes etc.) without touching the request path."""
        return self._bind().report(self.cfg, batch=batch, **kw)

    def stats(self) -> Dict[str, Any]:
        return dict(self.cache.stats(), mask_fp=self.mask_fp[:12],
                    arch_fp=self.arch_fp[:12], buckets=list(self.buckets),
                    level=self._level,
                    rung=rung_name(self._rungs[self._level]),
                    clean_streak=self._clean_streak,
                    resilience=dict(self.resilience))


def simulate_trace(batcher: BucketBatcher,
                   arrivals: Sequence[Tuple[float, int]],
                   service_time_s, *,
                   server: Optional[CnnServer] = None,
                   images_fn: Optional[Callable[[int, int], Any]] = None,
                   deadline_s: Optional[float] = None,
                   events: Sequence[Tuple[float, Callable[[], Any]]] = ()
                   ) -> Dict[str, Any]:
    """Virtual-clock queueing simulation: drive ``batcher`` with an
    arrival trace (``(t_seconds, n_images)`` per request) and a measured
    per-bucket service time (``service_time_s(bucket) -> s``), with no
    wall-clock sleeps. Each arrival is submitted as one (possibly
    multi-image) batcher request, matching :class:`CnnServer` semantics.
    Request latency = (release - arrival) + service time of the released
    bucket. Returns p50/p99 request latency, per-bucket release counts,
    total requests/images, and mean bucket fill (released images /
    released bucket capacity) — the number the max-wait deadline is
    tuning. Fill counts *images*, not requests: a released (bucket=4,
    one 4-image request) batch is full, not quarter-full.

    Resilience extensions (all optional, virtual-clock semantics):

    - ``deadline_s`` stamps every request with ``arrival + deadline_s``;
      the batcher sheds requests still pending past their deadline, and
      a full backlog (``batcher.max_pending_images``) sheds at submit —
      both counted (``shed_deadline`` / ``shed_overload``), and
      ``completed + shed == submitted`` always holds: no request hangs.
    - ``server`` (+ ``images_fn(request_id, n) -> (n, H, W, C)``) runs
      every released batch through the *real* serving path —
      ``CnnServer.infer`` with its fault hooks, retry/ladder machinery
      and guardrails — returning per-request ``outputs`` and the ladder
      ``rungs`` each answer ran under, so a chaos run can assert
      bit-exactness against clean per-rung reference servers.
    - ``events`` is a list of ``(t, fn)`` fired once the virtual clock
      reaches ``t`` (e.g. a mid-trace ``server.update_masks`` carrying a
      mask-corruption fault).
    """
    submit_t: Dict[int, float] = {}
    sizes: Dict[int, int] = {}
    latency: List[float] = []
    releases: Dict[int, int] = {}
    fill_img = fill_cap = images = submitted = 0
    shed_rids: List[int] = []
    outputs: Dict[int, np.ndarray] = {}
    rungs: Dict[int, int] = {}
    ev = sorted(events, key=lambda e: e[0])
    ev_i = 0

    def fire_events(now: float) -> None:
        nonlocal ev_i
        while ev_i < len(ev) and ev[ev_i][0] <= now:
            ev[ev_i][1]()
            ev_i += 1

    def drain_shed() -> None:
        for rid in batcher.take_shed():
            shed_rids.append(rid)
            submit_t.pop(rid, None)
            sizes.pop(rid, None)

    def record(now: float, batches) -> None:
        nonlocal fill_img, fill_cap
        drain_shed()
        for bucket, ids in batches:
            done = now + service_time_s(bucket)
            releases[bucket] = releases.get(bucket, 0) + 1
            imgs = sum(sizes[rid] for rid in ids)
            # a head request bigger than every bucket is released alone;
            # the server chunks it across ceil(n/bucket) max-bucket calls
            fill_cap += max(bucket, -(-imgs // bucket) * bucket)
            fill_img += imgs
            if server is not None and images_fn is not None:
                xs = np.concatenate([np.asarray(images_fn(rid, sizes[rid]))
                                     for rid in ids])
                y = server.infer(xs).cpu().numpy()
                off = 0
                for rid in ids:
                    outputs[rid] = y[off:off + sizes[rid]]
                    rungs[rid] = server.last_request_level
                    off += sizes[rid]
            for rid in ids:
                latency.append(done - submit_t.pop(rid))
                sizes.pop(rid)

    for t, n in sorted(arrivals):
        fire_events(t)
        # fire deadline flushes that elapse before this arrival
        while len(batcher):
            t_dl = batcher._pending[0].t_submit + batcher.max_wait_s
            if t_dl >= t:
                break
            # polling at exactly the deadline can miss it in floating
            # point ((t_submit + w) - t_submit < w); force the drain then
            record(t_dl, batcher.poll(t_dl) or batcher.poll(t_dl, flush=True))
        submitted += 1
        images += n
        try:
            rid = batcher.submit(
                n, t, deadline=None if deadline_s is None else t + deadline_s)
        except OverloadError:
            continue                     # counted in batcher.shed_overload
        submit_t[rid], sizes[rid] = t, n
        record(t, batcher.poll(t))
    fire_events(float("inf"))
    t_end = (max(p.t_submit for p in batcher._pending) + batcher.max_wait_s
             if len(batcher) else (sorted(arrivals)[-1][0] if arrivals else 0))
    record(t_end, batcher.poll(t_end, flush=True))
    drain_shed()

    lat = np.asarray(sorted(latency)) if latency else np.zeros(1)
    out: Dict[str, Any] = {
        "requests": len(latency),
        "images": images,
        "submitted": submitted,
        "shed": len(shed_rids) + batcher.shed_overload,
        "shed_deadline": batcher.shed_deadline,
        "shed_overload": batcher.shed_overload,
        "p50_s": float(np.percentile(lat, 50)),
        "p99_s": float(np.percentile(lat, 99)),
        "releases": {str(k): v for k, v in sorted(releases.items())},
        "mean_bucket_fill": fill_img / fill_cap if fill_cap else 0.0}
    assert out["requests"] + out["shed"] == submitted, \
        "every submitted request must complete or be shed — never hang"
    if server is not None:
        out["outputs"] = outputs
        out["rungs"] = rungs
        out["resilience"] = dict(server.resilience)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="CNN serving (HAPM "
                                 "block-sparse exec cache)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=None,
                    help="number of single-image requests to serve")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--folded", action="store_true")
    ap.add_argument("--streamed", action="store_true",
                    help="end-to-end int8 activation streaming (implies "
                         "--quantized --folded)")
    ap.add_argument("--activation-dsb", action="store_true",
                    help="skip all-zero activation windows on the int8 "
                         "wire (dual-sided sparsity; implies --streamed)")
    ap.add_argument("--buckets", type=int, nargs="+", default=None)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for the trace simulation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="serving device: the GPU by default (an error "
                         "without one); 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = cnn.resolve_device(args.device)

    from ..core import (HAPMConfig, apply_masks, hapm_element_masks,
                            hapm_epoch_update, hapm_init)

    if args.smoke:
        cfg = cnn.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)
        buckets = tuple(args.buckets or (1, 4, 8))
        n_req = args.requests or 6
        n_cu = 4
    else:
        cfg = cnn.ResNetConfig()
        buckets = tuple(args.buckets or DEFAULT_BUCKETS)
        n_req = args.requests or 32
        n_cu = 12
    params, state = cnn.init(args.seed, cfg, device=device)
    specs = cnn.conv_group_specs(params, n_cu)
    hcfg = HAPMConfig(args.sparsity, 1)
    st = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    pruned = apply_masks(params, hapm_element_masks(specs, st))

    streamed = args.streamed or args.activation_dsb
    spec = cnn.ExecSpec(quantized=args.quantized or streamed,
                        folded=args.folded or streamed,
                        streamed=streamed,
                        activation_dsb=args.activation_dsb, n_cu=n_cu)
    server = CnnServer(pruned, state, cfg, spec=spec, buckets=buckets,
                       device=device)
    t0 = time.time()
    server.warmup()
    print(f"[warmup] {len(buckets)} buckets, {server.cache.binds} bind(s) "
          f"in {time.time() - t0:.2f}s")

    rng = np.random.RandomState(args.seed)
    h = cfg.image_size
    per_req = []
    for _ in range(n_req):
        x = rng.rand(1, h, h, 3).astype(np.float32)
        t0 = time.time()
        server.infer(x).cpu()            # the copy back waits for the device
        per_req.append(time.time() - t0)
    lat = np.asarray(per_req)
    print(f"[serve] {n_req} single-image requests: "
          f"p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms")
    print(f"[cache] {server.stats()}")
    if args.activation_dsb:
        m = server._bind().measure_dsb_skip(
            server._tree, torch.as_tensor(x).to(server.device),
            server.run_cfg)
        print(f"[dsb] skip_frac {m['dsb_skip_frac']:.3f} "
              f"({m['dsb_skipped_steps']}/{m['dsb_live_steps']} steps)")

    # queueing behavior under a bursty arrival trace (virtual clock)
    batcher = BucketBatcher(buckets, max_wait_s=args.max_wait_ms / 1e3)
    svc = {b: float(np.median(lat)) for b in buckets}
    trace = [(float(t), 1) for t in
             np.cumsum(rng.exponential(args.max_wait_ms / 2e3, 4 * n_req))]
    sim = simulate_trace(batcher, trace, lambda b: svc[b],
                         deadline_s=None if args.deadline_ms is None
                         else args.deadline_ms / 1e3)
    print(f"[batcher] {sim}")
    return server


if __name__ == "__main__":
    main()
