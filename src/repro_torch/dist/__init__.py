"""Parallelism substrate: logical-axis sharding rules and spec derivation
for params/batches/caches, on ``torch.distributed`` device meshes.

``api``      — ``PartitionSpec``/``NamedSharding`` (specs and their DTensor
               placements), ``ShardingRules`` (logical axis -> mesh axis),
               the ``use_rules``/``current_rules`` context, and
               ``constrain`` (a DTensor redistributed under active rules,
               identity otherwise).
``sharding`` — ``ShardFlags``, ``make_rules`` (train/serve rule sets),
               and the tree spec derivers ``param_specs`` /
               ``batch_specs`` / ``cache_specs`` / ``to_shardings``.

The JAX package's ``dist.compat`` (its ``make_mesh``/``shard_map`` across
JAX versions) has no twin: meshes come from ``launch.mesh``, and the MoE
layer's manual region is written out in ``models.moe``.
"""
from . import api, sharding
from .api import (NamedSharding, P, PartitionSpec, ShardingRules, constrain,
                  current_rules, use_rules)
from .sharding import (ShardFlags, batch_specs, cache_specs, make_rules,
                       param_specs, to_shardings)

__all__ = [
    "api", "sharding",
    "NamedSharding", "P", "PartitionSpec",
    "ShardingRules", "constrain", "current_rules", "use_rules",
    "ShardFlags", "batch_specs", "cache_specs", "make_rules",
    "param_specs", "to_shardings",
]
