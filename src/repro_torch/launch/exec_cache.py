"""Persistent exec cache + bucketed batching for CNN serving.

A ``bind_execution`` is expensive relative to a steady-state forward:
plan construction is host-side numpy over every conv layer and bind-time
weight prepacking touches every masked tile (and the very first kernel
call builds the CUDA library). None of that should happen per request. This module provides the two serving primitives
:mod:`repro_torch.launch.serve_cnn` is built from:

- :class:`ExecCache` — a bounded LRU keyed on
  ``(arch fingerprint, sparsity-pattern fingerprint, ExecSpec, bucket)``.
  The first three components identify a *bind* (which weights, which live
  groups, which execution contract); the bucket identifies the
  batch shape. The bind itself is batch-agnostic, so entries that share
  ``key[:-1]`` share one :class:`~repro_torch.models.cnn.SparseConvExec` —
  serving batch 8 after batch 1 makes a new entry but does NOT re-plan or re-pack
  (``binds`` vs ``misses`` in :meth:`ExecCache.stats` makes the split
  observable). A HAPM epoch that prunes more groups changes the mask
  fingerprint; :meth:`ExecCache.invalidate` drops exactly the stale
  entries and the LRU bound caps growth regardless.

- :class:`BucketBatcher` — accumulates requests and releases them in
  bucket-aligned batches: immediately whenever the largest bucket fills,
  otherwise when the oldest pending request hits the max-wait deadline
  (then in the largest bucket that the backlog fills, repeatedly, with
  the smallest bucket mopping up the tail). Padding a short batch up to
  its bucket is exact for this model: eval-mode inference is per-image
  independent, so sliced rows are bit-identical to an unpadded run.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32, 128)


def bucket_for(batch: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that holds ``batch`` (9 -> 32 under the defaults).
    Batches beyond the largest bucket are the caller's job to chunk
    (:meth:`repro_torch.launch.serve_cnn.CnnServer.infer` splits them)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    for b in sorted(buckets):
        if batch <= b:
            return b
    raise ValueError(
        f"batch {batch} exceeds the largest bucket {max(buckets)} — "
        "chunk the request (serve_cnn.CnnServer.infer does)")


def arch_fingerprint(cfg, params) -> str:
    """Hex digest of the *architecture*: the model config plus every
    param leaf's path/shape/dtype (values excluded — weight updates that
    keep the sparsity pattern are the mask fingerprint's job to track,
    via the staleness guard + rebind, not a new architecture)."""
    import hashlib

    from ..core.masks import keystr, tree_flatten_with_path

    h = hashlib.sha1()
    h.update(repr(cfg).encode())
    for path, leaf in sorted(tree_flatten_with_path(params),
                             key=lambda kv: keystr(kv[0])):
        h.update(keystr(path).encode())
        h.update(str(tuple(int(d) for d in leaf.shape)).encode())
        # a dtype's numpy name ("float32"), whether the leaf is a tensor
        # or an array — so the digest equals the JAX package's
        h.update(str(leaf.dtype).replace("torch.", "").encode())
    return h.hexdigest()


@dataclasses.dataclass
class CacheEntry:
    """One serving callable (a plain closure — PyTorch runs eagerly) plus
    the bind it closes over."""
    exec_: Any                       # SparseConvExec (shared across buckets)
    fn: Callable[..., Any]           # forward closure of this bucket
    bucket: int


class ExecCache:
    """Bounded LRU of serving entries. Key:
    ``(arch_fp, mask_fp, ExecSpec, bucket)`` — :class:`ExecSpec` is frozen
    and hashable precisely so it can sit in this tuple.

    ``get``/``put`` are the hot path; ``shared_exec`` lets a miss reuse an
    already-bound exec from a sibling bucket so no bind is paid.
    Counters: ``hits``/``misses`` per lookup, ``binds`` counts actual
    ``bind_execution`` calls (misses that found a sibling bind don't
    re-bind), ``evictions`` LRU drops, ``invalidated`` explicit drops.
    """

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._quarantined: set = set()
        self.hits = 0
        self.misses = 0
        self.binds = 0
        self.evictions = 0
        self.invalidated = 0
        self.quarantined = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    def get(self, key: tuple) -> Optional[CacheEntry]:
        if key[:-1] in self._quarantined:
            self.misses += 1
            return None
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, key: tuple, entry: CacheEntry) -> CacheEntry:
        if key[:-1] in self._quarantined:
            raise RuntimeError(
                f"bind key {key[:-1]} is quarantined (produced non-finite "
                "outputs) — rebind one ladder rung down instead of "
                "re-caching it")
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def shared_exec(self, bind_key: tuple) -> Optional[Any]:
        """An already-bound exec for ``(arch_fp, mask_fp, spec)``, from
        any bucket's entry — the bind is batch-agnostic."""
        if bind_key in self._quarantined:
            return None
        for key, entry in self._entries.items():
            if key[:-1] == bind_key:
                return entry.exec_
        return None

    # -- quarantine (non-finite guardrail) ----------------------------
    def quarantine(self, bind_key: tuple) -> int:
        """Evict every bucket entry of this bind and refuse to serve or
        re-admit it (``get`` misses, ``put`` raises) until
        :meth:`clear_quarantine`. The serving guardrail calls this when a
        bind's outputs go non-finite — the degraded rebind happens one
        ladder rung *down*, never at the poisoned key. Returns the number
        of entries evicted."""
        stale = [k for k in self._entries if k[:-1] == bind_key]
        for k in stale:
            del self._entries[k]
        self._quarantined.add(bind_key)
        self.quarantined += 1
        return len(stale)

    def is_quarantined(self, bind_key: tuple) -> bool:
        return bind_key in self._quarantined

    def clear_quarantine(self) -> int:
        """Lift every quarantine (a mask update changed the binds — the
        poisoned fingerprints can no longer be produced). Returns how
        many keys were released."""
        n = len(self._quarantined)
        self._quarantined.clear()
        return n

    def invalidate(self, arch_fp: str,
                   keep_mask_fp: Optional[str] = None) -> int:
        """Drop every entry of this architecture whose mask fingerprint is
        not ``keep_mask_fp`` (``None`` drops them all). Returns the count.
        Called on HAPM mask change — entries of *other* architectures (or
        the surviving fingerprint) are untouched, so two models sharing
        the cache don't thrash each other."""
        stale = [k for k in self._entries
                 if k[0] == arch_fp and k[1] != keep_mask_fp]
        for k in stale:
            del self._entries[k]
        self.invalidated += len(stale)
        return len(stale)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, Any]:
        return {"size": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "binds": self.binds, "evictions": self.evictions,
                "invalidated": self.invalidated,
                "quarantined": self.quarantined,
                "hit_rate": self.hit_rate}


@dataclasses.dataclass
class _Pending:
    request_id: int
    batch: int
    t_submit: float
    deadline: Optional[float] = None


class BucketBatcher:
    """Deadline-driven bucket accumulator (virtual-clock friendly: the
    caller supplies ``now`` to every call, so the serving bench can drive
    it with a simulated arrival trace instead of wall-clock sleeps).

    ``submit`` enqueues a request of ``batch`` images; ``poll`` returns
    the batches to release *now* as ``(bucket, [request_ids])`` tuples:

    - whenever the backlog fills the largest bucket, a full max-bucket
      batch flushes immediately (no deadline wait — it cannot get better);
    - when the oldest pending request has waited ``max_wait_s``, the
      backlog drains in bucket-aligned chunks: largest bucket <= pending
      count, repeatedly, then the smallest bucket carries the remainder
      (padded — exactness is the model's per-image independence).

    Requests are indivisible here (one request = one image row count);
    multi-image requests are split into per-chunk submissions by the
    server before they reach the batcher.

    **Deadlines + admission control** (the overload story): ``submit``
    accepts an optional absolute ``deadline``; a pending request whose
    deadline passes before it is released is *shed* at the next ``poll``
    (dropped from the queue, its id retrievable via :meth:`take_shed`,
    counted in ``shed_deadline``) — a queue that cannot keep up sheds
    late work instead of serving it pointlessly late. With
    ``max_pending_images`` set, ``submit`` refuses work that would push
    the backlog past the budget (raises
    :class:`repro_torch.launch.resilience.OverloadError`, counted in
    ``shed_overload``) — the caller decides whether to retry, degrade or
    propagate. Requests never hang: every submitted id either comes back
    from ``poll`` or from ``take_shed``.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.005,
                 max_pending_images: Optional[int] = None):
        if not buckets:
            raise ValueError("need at least one bucket")
        if max_pending_images is not None and max_pending_images < 1:
            raise ValueError(
                f"max_pending_images must be >= 1, got {max_pending_images}")
        self.buckets = tuple(sorted(buckets))
        self.max_wait_s = max_wait_s
        self.max_pending_images = max_pending_images
        self._pending: List[_Pending] = []
        self._shed: List[int] = []
        self._next_id = 0
        self.shed_deadline = 0
        self.shed_overload = 0

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending_images(self) -> int:
        return sum(p.batch for p in self._pending)

    def submit(self, batch: int, now: float,
               deadline: Optional[float] = None) -> int:
        """Enqueue a request of ``batch`` images; returns its id.
        ``deadline`` (absolute, same clock as ``now``) marks the request
        sheddable: if it is still pending when the deadline passes, the
        next ``poll`` drops it instead of releasing it. Raises
        :class:`~repro_torch.launch.resilience.OverloadError` (without
        enqueueing) when the backlog budget would be exceeded."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if (self.max_pending_images is not None
                and self.pending_images + batch > self.max_pending_images):
            from .resilience import OverloadError
            self.shed_overload += 1
            raise OverloadError(
                f"request of {batch} image(s) would push the backlog to "
                f"{self.pending_images + batch} > budget "
                f"{self.max_pending_images} — shed")
        rid = self._next_id
        self._next_id += 1
        self._pending.append(_Pending(rid, batch, now, deadline))
        return rid

    def take_shed(self) -> List[int]:
        """Drain and return the ids shed since the last call (deadline
        expiries found by ``poll``). Overload-shed requests never get an
        id — ``submit`` raises before enqueueing them."""
        out, self._shed = self._shed, []
        return out

    def poll(self, now: float, flush: bool = False
             ) -> List[Tuple[int, List[int]]]:
        """Batches to release at time ``now``. ``flush=True`` drains
        everything regardless of deadline (shutdown / end of trace).
        Pending requests whose deadline has passed are shed first (even
        under ``flush`` — serving them would only waste the bucket)."""
        kept = []
        for p in self._pending:
            if p.deadline is not None and now > p.deadline:
                self._shed.append(p.request_id)
                self.shed_deadline += 1
            else:
                kept.append(p)
        self._pending = kept
        out: List[Tuple[int, List[int]]] = []
        max_bucket = self.buckets[-1]

        def take(n_images: int) -> Tuple[int, List[int]]:
            ids, total = [], 0
            while self._pending and total + self._pending[0].batch <= n_images:
                p = self._pending.pop(0)
                ids.append(p.request_id)
                total += p.batch
            return total, ids

        # full max-bucket batches flush unconditionally
        while self.pending_images >= max_bucket:
            total, ids = take(max_bucket)
            if not ids:       # head request alone exceeds the max bucket
                break
            out.append((max_bucket, ids))

        deadline_hit = (self._pending
                        and now - self._pending[0].t_submit >= self.max_wait_s)
        if flush or deadline_hit:
            while self._pending:
                pending = self.pending_images
                bucket = self.buckets[0]
                for b in self.buckets:
                    if b <= pending:
                        bucket = b
                total, ids = take(bucket)
                if not ids:
                    # head request bigger than every bucket — release it
                    # alone; the server chunks it across max-bucket calls
                    p = self._pending.pop(0)
                    out.append((max_bucket, [p.request_id]))
                    continue
                out.append((bucket_for(max(total, 1), self.buckets), ids))
        return out
