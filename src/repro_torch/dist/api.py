"""Logical-axis sharding rules.

Model code names *logical* axes (``batch``/``seq``/``embed``/``heads``/
``ffn``/``vocab``/``fsdp``); a ``ShardingRules`` maps each to zero or more
*mesh* axes. The mapping is installed for the duration of a call with
``use_rules`` and consumed by ``constrain`` — so the same model code runs
unsharded (unit tests, single process) and under a mesh without
branching.

Rule values:
  ``None``            — replicated
  ``"model"``         — one mesh axis (spec entry stays a string)
  ``("pod", "data")`` — several mesh axes (spec entry stays a tuple)

``spec`` dedupes mesh axes left-to-right: once a mesh axis is consumed by
an earlier dimension, later dimensions naming it come out replicated
(a spec may not repeat a mesh axis).

PyTorch has no ``PartitionSpec``, so this module defines one with the JAX
forms (a tuple of ``None``, a mesh-axis name or a tuple of names), and a
``NamedSharding`` (mesh plus spec) whose ``placements`` are the DTensor
``Shard(d)``/``Replicate()`` of each mesh dim. The mesh is a
``torch.distributed.device_mesh.DeviceMesh``; ``mesh_shape`` also reads
any object whose ``shape`` is a ``{name: size}`` mapping.

``constrain`` runs eagerly in one process. JAX's
``with_sharding_constraint`` is a compile-time layout hint that never
changes values; here a ``DTensor`` is redistributed to the spec's
placements and a plain tensor comes back unchanged. The models run on
local tensors: activations are not made DTensors, because DTensor has no
sharding rule for several operations the MoE dispatch uses (``topk``,
``cumsum``, a scatter with a dropped slot).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

MeshAxes = Union[None, str, Tuple[str, ...]]
LogicalAxes = Union[None, str]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh-axis name, or
    a tuple of mesh-axis names (the dim split over all of them, the first
    the major one)."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """{mesh-axis name: size} of a ``DeviceMesh`` or of any object whose
    ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, major first."""
    return tuple(mesh_shape(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh plus the spec a tensor is laid out by on it."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements, one per mesh dim: ``Shard(d)`` where tensor dim
    ``d``'s entry names that mesh axis, else ``Replicate()``. A dim split
    over several mesh axes shards on each of them; its tuple must list them
    in the mesh's dim order (DTensor splits in that order), or this
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names mesh axes {missing} the mesh "
                             f"{names} does not have")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, not in the "
                             f"mesh's dim order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus the logical-axis -> mesh-axis mapping active on it.

    ``rules`` may also carry boolean strategy flags (e.g.
    ``moe_manual_tp``) that layer implementations query via
    ``rules.rules.get(...)``; only string/tuple values participate in
    ``spec``.
    """
    mesh: Any
    rules: Dict[str, Any]

    def spec(self, *logical_axes: LogicalAxes) -> PartitionSpec:
        """PartitionSpec for a tensor whose dims carry ``logical_axes``.

        ``None`` and unknown logical names map to replicated dims.
        """
        entries = []
        used: set = set()
        for ax in logical_axes:
            rule = self.rules.get(ax) if ax is not None else None
            entries.append(_take(rule, used))
        return P(*entries)

    def sharding(self, *logical_axes: LogicalAxes) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(*logical_axes))


def _take(rule: Any, used: set) -> MeshAxes:
    """Resolve one rule value against already-consumed mesh axes."""
    if rule is None or rule is True or rule is False:
        return None
    if isinstance(rule, str):
        if rule in used:
            return None
        used.add(rule)
        return rule
    kept = []
    for a in rule:
        if a not in used:
            used.add(a)
            kept.append(a)
    return tuple(kept) if kept else None


# ---------------------------------------------------------------------------
# Active-rules context
# ---------------------------------------------------------------------------

_STACK: list = []


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Install ``rules`` for the duration of the block (reentrant).

    ``use_rules(None)`` is allowed and makes ``constrain`` a no-op inside —
    callers can thread an optional rules object without branching.
    """
    _STACK.append(rules)
    try:
        yield rules
    finally:
        _STACK.pop()


def current_rules() -> Optional[ShardingRules]:
    return _STACK[-1] if _STACK else None


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

def axes_size(mesh, entry: MeshAxes) -> int:
    """Total number of shards a spec entry induces on its dim."""
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, str):
        return shape[entry]
    return int(np.prod([shape[a] for a in entry], dtype=np.int64)) if entry else 1


def divisible_spec(spec: PartitionSpec, shape: Sequence[int], mesh) -> PartitionSpec:
    """Replicate any dim the mesh cannot split evenly.

    The fallback of record for smoke configs and elastic restarts: a dim
    whose size does not divide by the assigned mesh-axes product comes out
    ``None`` instead of erroring (uneven shards would silently pad).
    """
    entries = []
    for i, e in enumerate(spec):
        if i >= len(shape):
            entries.append(None)
            continue
        n = axes_size(mesh, e)
        entries.append(e if n <= 1 or shape[i] % n == 0 else None)
    return P(*entries)


def constrain(x, *logical_axes: LogicalAxes):
    """Under active rules: the spec ``rules.spec(*logical_axes)`` (trailing
    dims replicated, indivisible dims replicated, see ``divisible_spec``),
    a ``DTensor`` redistributed to its placements and any other tensor
    returned unchanged. The identity (same object) when no rules are
    installed."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical_axes) > x.ndim:
        raise ValueError(
            f"constrain: {len(logical_axes)} logical axes for rank-{x.ndim} "
            f"value {tuple(getattr(x, 'shape', ()))}")
    spec = divisible_spec(rules.spec(*logical_axes), x.shape, rules.mesh)
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(rules.mesh, placements(spec, rules.mesh))
    return x
