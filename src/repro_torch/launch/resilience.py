"""Resilience primitives for the CNN serving stack: fault injection,
deadlines + load shedding, and the graceful-degradation ladder.

A production sparse accelerator degrades instead of failing: HPIPE falls
back across heterogeneous per-layer configurations when a stage cannot
hold its plan, and a dual-sided sparse engine must stay *correct* when
its sparsity assumptions break. This port gets the same property via
three pieces, all consumed by :class:`repro_torch.launch.serve_cnn.CnnServer`:

- :class:`FaultPlan` — a seeded, deterministic chaos schedule. Hooks in
  the server's bind/forward/mask-update paths consult it, so injected
  faults (bind failures, bind latency, non-finite layer outputs,
  corrupted mask updates) exercise the *real* serving code, not mocks.
- :class:`ServePolicy` — the knobs of the recovery machinery: bounded
  bind retries with exponential backoff, the non-finite output
  guardrail, mask validation, per-request deadlines, and the overload
  (admission-control) action.
- :func:`degradation_ladder` — the spec downgrade order
  ``streamed → quantized → f32 packed → dense library conv``. Every rung is
  a *valid* :class:`~repro_torch.models.cnn.ExecSpec` (or ``None`` for the
  dense fallback), and a degraded answer is still bit-exact **for the
  spec it ran under** — the ladder trades throughput for availability,
  never correctness.

Error taxonomy: bind failures are
:class:`repro_torch.models.cnn.TransientBindError` (retryable — the ladder
retries with backoff before downgrading) or
:class:`~repro_torch.models.cnn.PermanentBindError` (contract violations —
retrying is pointless, the ladder downgrades immediately). Request-level
failures raise :class:`DeadlineExceeded` (the request could not finish
inside its deadline), :class:`OverloadError` (admission control shed it
before any work happened) or :class:`NonFiniteOutputError` (every rung
down to dense produced non-finite values — the server refuses to answer
rather than answer wrongly).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.cnn import ExecSpec, PermanentBindError, TransientBindError

# the dense library-conv rung at the bottom of every ladder: no sparse exec,
# no bind to fail — the spec component of its cache key
DENSE_RUNG = "dense"


class DeadlineExceeded(RuntimeError):
    """The request could not complete inside its deadline. Raised *before*
    starting work the deadline cannot absorb — the request is shed and
    counted, never left hanging on a forward call."""


class OverloadError(RuntimeError):
    """Admission control shed the request: accepting it would push the
    pending-work budget past its limit."""


class NonFiniteOutputError(RuntimeError):
    """Every degradation rung down to dense produced non-finite outputs.
    The server never returns a wrong (non-finite) answer — it raises."""


def degradation_ladder(spec: ExecSpec) -> Tuple[Any, ...]:
    """The graceful-degradation rungs for ``spec``, fastest first:
    ``streamed → quantized → f32 → dense`` (``None`` = dense library conv).
    Each step clears exactly one capability, so every intermediate rung is
    a valid :class:`ExecSpec` (the ``folded``/``packed`` structure of the
    bind is preserved — only the wire/operand contract degrades). A spec
    that already sits low on the ladder just gets the rungs below it.

    ``activation_dsb`` rides the int8 wire: it survives the
    ``streamed → quantized`` step (the skip keys on exact int8 codes,
    which plain-quantized binds still carry) and is cleared together
    with ``quantized`` — an f32 rung has no exact zero codes to test,
    and :class:`ExecSpec` validation rejects the combination."""
    rungs: List[Any] = [spec]
    s = spec
    if s.streamed:
        s = dataclasses.replace(s, streamed=False)
        rungs.append(s)
    if s.quantized:
        s = dataclasses.replace(s, quantized=False, activation_dsb=False)
        rungs.append(s)
    rungs.append(None)                      # dense library conv fallback
    return tuple(rungs)


def rung_name(rung: Any) -> str:
    """Human-readable ladder rung label (for logs/stats)."""
    if rung is None:
        return DENSE_RUNG
    if rung.streamed:
        return "streamed"
    if rung.quantized:
        return "quantized"
    return "f32"


def retry_bind(bind_fn: Callable[[], Any], *, retries: int = 2,
               backoff_s: float = 0.005, factor: float = 2.0,
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable[[int], None]] = None) -> Any:
    """Run ``bind_fn`` with bounded retries on
    :class:`~repro_torch.models.cnn.TransientBindError`, exponential backoff
    between attempts. Permanent bind errors (and everything else)
    propagate immediately — retrying a contract violation cannot succeed,
    the caller should move down the ladder instead. ``on_retry(attempt)``
    is called before each re-attempt (the server counts them)."""
    delay = backoff_s
    attempt = 0
    while True:
        try:
            return bind_fn()
        except TransientBindError:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt)
            sleep(delay)
            delay *= factor
            attempt += 1


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Recovery/overload knobs of one :class:`CnnServer`.

    ``max_bind_retries``/``bind_backoff_s``/``bind_backoff_factor``:
    bounded-retry bind with exponential backoff — only *transient* bind
    errors retry; permanent ones go straight down the ladder.
    ``check_finite``: the non-finite output guardrail — a non-finite
    result quarantines the offending cache entry, rebinds one rung down
    and re-runs; the server never returns a non-finite answer.
    ``validate_masks``: fingerprint-check mask updates (and snapshot
    restores) against the freshly-derived pattern, repairing corruption
    instead of serving wrong plans. ``allow_degrade``: master switch for
    the ladder (off = failures raise after retries).
    ``max_request_images``: admission-control budget — a request bigger
    than this is shed (``overload_action="shed"``, raises
    :class:`OverloadError`) or served one ladder rung down
    (``"degrade"`` — cheaper, but served). ``default_deadline_s``: the
    deadline applied when ``infer`` is called without one (``None`` = no
    deadline). ``promote_after_clean``: latency-aware ladder *promotion*
    — after this many consecutive requests served entirely clean (no
    degradation, no retry, no guardrail trip) while sitting on a
    degraded rung, the server walks back **up** one rung and re-earns
    the faster contract; ``None`` disables promotion (degradation stays
    sticky, the pre-promotion behavior)."""

    max_bind_retries: int = 2
    bind_backoff_s: float = 0.005
    bind_backoff_factor: float = 2.0
    check_finite: bool = True
    validate_masks: bool = True
    allow_degrade: bool = True
    max_request_images: Optional[int] = None
    overload_action: str = "shed"
    default_deadline_s: Optional[float] = None
    promote_after_clean: Optional[int] = None

    def __post_init__(self):
        if self.overload_action not in ("shed", "degrade"):
            raise ValueError(
                f"overload_action must be 'shed' or 'degrade', got "
                f"{self.overload_action!r}")
        if self.max_bind_retries < 0:
            raise ValueError(
                f"max_bind_retries must be >= 0, got {self.max_bind_retries}")
        if self.promote_after_clean is not None and self.promote_after_clean < 1:
            raise ValueError(
                f"promote_after_clean must be >= 1 (or None to disable), "
                f"got {self.promote_after_clean}")


@dataclasses.dataclass
class FaultPlan:
    """Seeded, deterministic fault schedule for chaos runs.

    Three injection sites, each with an explicit per-call schedule
    (0-based call indices — exact, for tests) and/or a seeded rate
    (for chaos sweeps; the draw sequence is deterministic given ``seed``
    and the single-threaded call order):

    - **bind** (``CnnServer`` bind path): ``bind_delay_*`` sleeps
      ``bind_delay_s`` before the bind (latency inflation);
      ``bind_fail_*`` raises — :class:`TransientBindError` by default
      (the retry/backoff path), :class:`PermanentBindError` when
      ``bind_fail_permanent`` (the straight-to-downgrade path).
    - **output** (after each forward): ``nonfinite_*`` overwrites
      one logit with ``nonfinite_value`` (NaN by default) — the
      guardrail must catch it, quarantine the entry and rebind a rung
      down.
    - **masks** (mask derivation during install/update): ``mask_corrupt_*``
      flips one group bit in one layer's mask — validation must detect
      the fingerprint mismatch and repair.

    ``max_faults`` caps total injections (so a chaos run converges).
    ``injected`` counts per kind; ``record`` logs ``(site, call_idx,
    kind)`` tuples in injection order."""

    seed: int = 0
    bind_fail_calls: Tuple[int, ...] = ()
    bind_fail_rate: float = 0.0
    bind_fail_permanent: bool = False
    bind_delay_calls: Tuple[int, ...] = ()
    bind_delay_rate: float = 0.0
    bind_delay_s: float = 0.0
    nonfinite_calls: Tuple[int, ...] = ()
    nonfinite_rate: float = 0.0
    nonfinite_value: float = float("nan")
    mask_corrupt_calls: Tuple[int, ...] = ()
    mask_corrupt_rate: float = 0.0
    max_faults: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        self.calls: Dict[str, int] = {"bind": 0, "output": 0, "masks": 0}
        self.injected: Dict[str, int] = {"bind_fail": 0, "bind_delay": 0,
                                         "nonfinite": 0, "mask_corrupt": 0}
        self.record: List[Tuple[str, int, str]] = []

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _fire(self, site: str, idx: int, kind: str,
              schedule: Tuple[int, ...], rate: float) -> bool:
        if (self.max_faults is not None
                and self.total_injected >= self.max_faults):
            return False
        hit = idx in schedule
        if not hit and rate > 0.0:
            hit = bool(self._rng.random_sample() < rate)
        if hit:
            self.injected[kind] += 1
            self.record.append((site, idx, kind))
        return hit

    # -- hook sites ----------------------------------------------------
    def on_bind(self, spec: Any) -> None:
        """Called by the server immediately before ``bind_execution``.
        May sleep (latency fault) and/or raise (bind failure)."""
        idx = self.calls["bind"]
        self.calls["bind"] = idx + 1
        if self._fire("bind", idx, "bind_delay",
                      self.bind_delay_calls, self.bind_delay_rate):
            self.sleep(self.bind_delay_s)
        if self._fire("bind", idx, "bind_fail",
                      self.bind_fail_calls, self.bind_fail_rate):
            err = (PermanentBindError if self.bind_fail_permanent
                   else TransientBindError)
            raise err(f"injected bind failure (call {idx}, "
                      f"spec={rung_name(spec)})")

    def on_output(self, y):
        """Called on each forward's output (a tensor); may return a corrupted
        copy (one non-finite logit) for the guardrail to catch."""
        idx = self.calls["output"]
        self.calls["output"] = idx + 1
        if self._fire("output", idx, "nonfinite",
                      self.nonfinite_calls, self.nonfinite_rate):
            y = y.clone()
            y.view(-1)[0] = self.nonfinite_value
            return y
        return y

    def on_masks(self, masks: Dict[tuple, np.ndarray]) -> Dict[tuple, np.ndarray]:
        """Called on each derived group-mask set; may return a copy with
        one flipped group bit (a corrupted mask update) for validation to
        detect and repair."""
        idx = self.calls["masks"]
        self.calls["masks"] = idx + 1
        if self._fire("masks", idx, "mask_corrupt",
                      self.mask_corrupt_calls, self.mask_corrupt_rate):
            out = {k: np.array(v) for k, v in masks.items()}
            key = sorted(out)[int(self._rng.randint(len(out)))]
            m = out[key]
            i = int(self._rng.randint(m.size))
            m.flat[i] = 0.0 if m.flat[i] > 0 else 1.0
            return out
        return masks
