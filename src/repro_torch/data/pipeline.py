"""Input pipeline: host -> device placement with global-batch sharding and
background prefetch (overlaps host batch synthesis/augmentation with
device compute).

On the card a host batch is copied from pinned memory with
``non_blocking=True``. ``prefetch`` makes those copies on a stream of its
own from a background thread and hands each batch over with an event
recorded after its copies: the consumer's stream waits on that event
before it reads the batch, so a prefetched batch is complete when it is
used.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..core.masks import tree_leaves, tree_map
from ..dist.api import ShardingRules, placements
from ..dist.sharding import batch_specs
from ..models.cnn import resolve_device

PyTree = Any


def _to_device(x, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
        else torch.as_tensor(x)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def shard_batch(batch: PyTree, rules: Optional[ShardingRules], device=None) -> PyTree:
    """Host batch (numpy arrays or tensors) -> tensors on the device (the
    card unless ``device`` says otherwise), ``None`` leaves kept. Under
    ``rules`` each leaf is a DTensor on the rules' mesh, laid out by
    ``batch_specs`` (leading dim over the batch axes)."""
    if rules is None:
        dev = resolve_device(device)
        return tree_map(lambda x: _to_device(x, dev), batch)
    from torch.distributed.tensor import distribute_tensor
    mesh = rules.mesh
    dev = resolve_device(mesh.device_type)
    specs = batch_specs(batch, rules)
    return tree_map(
        lambda x, s: distribute_tensor(_to_device(x, dev), mesh, placements(s, mesh)),
        batch, specs)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def prefetch(it: Iterator[PyTree], rules: Optional[ShardingRules] = None,
             depth: int = 2, device=None) -> Iterator[PyTree]:
    """Background-thread prefetch of device-placed batches, at most
    ``depth`` ahead. The stream ends when ``it`` does; an error of ``it``
    (or of a copy) ends it too and is raised to the consumer."""
    dev = resolve_device(device if rules is None else rules.mesh.device_type)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    failed = []

    def worker():
        try:
            for b in it:
                if copy_stream is None:
                    q.put((shard_batch(b, rules, dev), None))
                    continue
                with torch.cuda.stream(copy_stream):
                    placed = shard_batch(b, rules, dev)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                q.put((placed, done))
        except BaseException as e:      # handed to the consumer below
            failed.append(e)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            if failed:
                raise failed[0]
            return
        b, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for leaf in tree_leaves(b):
                # the allocator must not hand these blocks back to the copy
                # stream while the consumer's stream may still read them
                _local(leaf).record_stream(consumer)
        yield b
