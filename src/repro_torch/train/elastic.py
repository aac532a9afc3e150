"""Elastic scaling: restart a job on a different mesh shape.

Checkpoints store logical (full) arrays (see ``train.checkpoint``), so
elasticity reduces to: restore -> ``distribute_tensor`` each leaf with
the sharding derived from the *new* mesh's rules. Divisibility fallbacks
in ``dist.sharding`` keep small tensors replicated when the new mesh is
larger than a dimension allows.
"""
from __future__ import annotations

from typing import Any, Optional

from ..core.masks import tree_flatten_with_path
from ..dist.api import NamedSharding, PartitionSpec, ShardingRules
from . import checkpoint as ckpt

PyTree = Any


def restore_elastic(
    ckpt_dir: str,
    skeleton: PyTree,
    rules: Optional[ShardingRules],
    spec_tree: Optional[PyTree] = None,
    step: Optional[int] = None,
):
    """Restore a checkpoint onto the current mesh.

    ``spec_tree`` mirrors ``skeleton`` with PartitionSpecs (from
    ``dist.sharding.param_specs``); leaves without a spec are replicated.
    Without rules or specs the leaves come back as numpy arrays, as
    ``checkpoint.restore`` gives them.
    """
    if rules is None or spec_tree is None:
        return ckpt.restore(ckpt_dir, skeleton, step=step)

    flat_specs = dict(tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: x is None or isinstance(x, PartitionSpec)))

    def sharding_fn(path, arr):
        spec = flat_specs.get(tuple(path))
        return NamedSharding(rules.mesh, PartitionSpec() if spec is None else spec)

    return ckpt.restore(ckpt_dir, skeleton, step=step, sharding_fn=sharding_fn)
