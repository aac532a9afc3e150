"""Fault-tolerant checkpointing: atomic (tmp + rename), manifested,
keep-last-k, resumable.

Arrays are stored *logically* (full values, path-keyed inside an .npz), as
the JAX package stores them: the same tree saves to the same file names and
keys (``"|"``-joined dict keys, sorted; sequence indices; named-tuple
field names), so a checkpoint written by either package restores in the
other. Tensors are saved from the host; :func:`restore` returns numpy
arrays, or tensors on ``device`` when one is given. Only rank 0 of an
initialized ``torch.distributed`` group writes. SIGTERM-triggered emergency
saves via ``install_signal_save``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import tempfile
import time
import warnings
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

PyTree = Any

_SEP = "|"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory exists but cannot be read back — truncated
    arrays, unparseable manifest, or a manifest/payload count mismatch
    (a partially-written or bit-rotted save)."""


def _children(node):
    """(key, child) pairs of a tree node, in the JAX package's flatten
    order, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return dict(children)
    values = [v for _, v in children]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: PyTree) -> dict:
    flat = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            flat[_SEP.join(str(k) for k in path)] = _to_numpy(node)
            return
        for k, v in kids:
            walk(v, path + (k,))

    walk(tree, ())
    return flat


def _unflatten_into(skeleton: PyTree, flat: dict, place=None) -> PyTree:
    def walk(node, path):
        if node is None:
            return None
        kids = _children(node)
        if kids is not None:
            return _rebuild(node, [(k, walk(v, path + (k,))) for k, v in kids])
        key = _SEP.join(str(k) for k in path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if hasattr(node, "shape") and tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                             f"model {tuple(node.shape)}")
        return arr if place is None else place(arr)

    return walk(skeleton, ())


def _is_writer() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def save(ckpt_dir: str, step: int, tree: PyTree, *, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Atomic save. Returns the final checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if not _is_writer():
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "time": time.time(), "n_arrays": len(flat),
                "bytes": int(sum(a.nbytes for a in flat.values()))}
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{10})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True when ``step``'s checkpoint reads back intact: parseable
    manifest, CRC-clean ``arrays.npz`` (catches truncation even when the
    zip directory survived), and an array count matching the manifest."""
    path = _step_path(ckpt_dir, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
            if z.testzip() is not None:
                return False
            n = len(z.namelist())
        n_meta = meta.get("n_arrays")
        return n_meta is None or n == int(n_meta)
    except Exception:
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *readable* step — partially-written or corrupt checkpoints
    are skipped (with a warning), falling back to the previous save."""
    for s in reversed(all_steps(ckpt_dir)):
        if verify_step(ckpt_dir, s):
            return s
        warnings.warn(f"skipping corrupt/partial checkpoint "
                      f"{_step_path(ckpt_dir, s)!r} — falling back to an "
                      "older step")
    return None


def _read_flat(ckpt_dir: str, step: Optional[int]) -> tuple:
    """(flat dict, manifest) for ``step`` (default: newest readable)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no readable checkpoints in {ckpt_dir}")
    elif not os.path.exists(os.path.join(_step_path(ckpt_dir, step),
                                         "manifest.json")):
        raise FileNotFoundError(f"no checkpoint for step {step} in {ckpt_dir}")
    path = _step_path(ckpt_dir, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} is unreadable ({type(e).__name__}: {e}) — "
            "partially written or corrupted on disk") from e
    n_meta = meta.get("n_arrays")
    if n_meta is not None and len(flat) != int(n_meta):
        raise CorruptCheckpointError(
            f"checkpoint {path!r} holds {len(flat)} arrays but its manifest "
            f"promises {n_meta} — partially written save")
    return flat, meta


def load_flat(ckpt_dir: str, step: Optional[int] = None) -> tuple:
    """Skeleton-free load: ``({path-key: np.ndarray}, manifest)`` for
    ``step`` (default: the newest readable checkpoint — corrupt ones are
    skipped with a warning)."""
    return _read_flat(ckpt_dir, step)


def restore(ckpt_dir: str, skeleton: PyTree, step: Optional[int] = None,
            device=None) -> tuple:
    """Restore into ``skeleton``'s structure. Returns (tree, manifest); the
    leaves are numpy arrays, or tensors on ``device`` when one is given.
    With ``step=None`` corrupt/partial checkpoints are skipped (warned) in
    favor of the newest readable one; an explicitly-requested corrupt step
    raises :class:`CorruptCheckpointError`."""
    flat, meta = _read_flat(ckpt_dir, step)
    place = None if device is None else (
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device))
    return _unflatten_into(skeleton, flat, place), meta


# signum -> {"fn": current save fn, "prev": handler we displaced}; module
# state so repeat installs stay idempotent instead of stacking handlers
_SIGNAL_SAVES: dict = {}


def install_signal_save(fn: Callable[[], None], signals=(signal.SIGTERM, signal.SIGINT)):
    """Emergency checkpoint on preemption (SIGTERM is what a cluster sends).

    Whatever handler was installed before is *chained* (called after the
    save) rather than silently displaced, and repeat installs are
    idempotent — the newest ``fn`` replaces the old one inside the single
    installed handler, so one signal triggers one save."""
    for s in signals:
        rec = _SIGNAL_SAVES.get(s)
        if rec is not None:
            rec["fn"] = fn              # idempotent: one handler, newest fn
            continue
        rec = {"fn": fn, "prev": signal.getsignal(s)}
        _SIGNAL_SAVES[s] = rec

        def handler(signum, frame, _rec=rec):
            _rec["fn"]()
            prev = _rec["prev"]
            if callable(prev):          # chain a displaced python handler
                prev(signum, frame)
            raise SystemExit(128 + signum)

        signal.signal(s, handler)


def uninstall_signal_save(signals=(signal.SIGTERM, signal.SIGINT)):
    """Restore the handlers :func:`install_signal_save` displaced."""
    for s in signals:
        rec = _SIGNAL_SAVES.pop(s, None)
        if rec is not None:
            signal.signal(s, rec["prev"] if rec["prev"] is not None
                          else signal.SIG_DFL)
