"""Deterministic synthetic datasets (offline container: no downloads).

* ``SyntheticCifar`` — 32×32×3 / 10-class images with class-conditional
  low-frequency structure + noise: learnable to high accuracy by the
  paper's CNN, so pruning-method *accuracy deltas* are measurable. Loads
  real CIFAR-10 automatically if ``$CIFAR10_DIR`` points at the python
  pickle batches (absolute accuracies then comparable to the paper).
* ``TokenStream`` — LM token sequences from a seeded order-1 Markov chain
  with copy motifs: next-token loss decreases well below the uniform
  baseline within a few hundred steps of a ~100M model.

Both are shard-aware: ``host_slice(process_index, process_count)`` gives
disjoint streams for multi-host data loading.

Pure numpy, the JAX package's generators line for line: the same seeds give
the same arrays (asserted in ``tests/test_torch_data.py``). Batches stay
host arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticCifar:
    num_train: int = 8192
    num_test: int = 2048
    num_classes: int = 10
    seed: int = 0
    image_size: int = 32

    def __post_init__(self):
        cifar_dir = os.environ.get("CIFAR10_DIR")
        if cifar_dir and os.path.isdir(cifar_dir):
            self._load_real(cifar_dir)
            return
        rng = np.random.RandomState(self.seed)
        s = self.image_size
        # class templates: sum of a few random low-frequency sinusoids per channel
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        temps = []
        for c in range(self.num_classes):
            img = np.zeros((s, s, 3), np.float32)
            for _ in range(4):
                fx, fy = rng.uniform(0.5, 4, 2)
                ph = rng.uniform(0, 2 * np.pi, 3)
                amp = rng.uniform(0.3, 1.0, 3)
                for ch in range(3):
                    img[:, :, ch] += amp[ch] * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph[ch])
            temps.append(img)
        self._templates = np.stack(temps)          # (C, s, s, 3)

        def make(n, seed):
            r = np.random.RandomState(seed)
            labels = r.randint(0, self.num_classes, n).astype(np.int32)
            shift = r.randint(-4, 5, (n, 2))
            imgs = self._templates[labels]
            # per-sample circular shift (weak augmentation baked in) + noise
            out = np.empty_like(imgs)
            for i in range(n):
                out[i] = np.roll(imgs[i], tuple(shift[i]), axis=(0, 1))
            out = out + r.normal(0, 0.35, out.shape).astype(np.float32)
            out = (out - out.min()) / (out.max() - out.min() + 1e-6)
            return out.astype(np.float32), labels

        self.train_x, self.train_y = make(self.num_train, self.seed + 1)
        self.test_x, self.test_y = make(self.num_test, self.seed + 2)

    def _load_real(self, d):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xs.append(b[b"data"]); ys.append(b[b"labels"])
        self.train_x = (np.concatenate(xs).reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
        self.train_y = np.concatenate(ys).astype(np.int32)
        with open(os.path.join(d, "test_batch"), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        self.test_x = (np.asarray(b[b"data"]).reshape(-1, 3, 32, 32)
                       .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
        self.test_y = np.asarray(b[b"labels"]).astype(np.int32)
        self.num_train, self.num_test = len(self.train_y), len(self.test_y)

    def epoch(self, batch_size: int, *, seed: int, augment: bool = True,
              process_index: int = 0, process_count: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One shuffled epoch, host-sliced, with flip/shift augmentation."""
        r = np.random.RandomState(seed)
        order = r.permutation(self.num_train)[process_index::process_count]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            x = self.train_x[idx]
            if augment:
                flip = r.rand(len(idx)) < 0.5
                x = np.where(flip[:, None, None, None], x[:, :, ::-1], x)
            yield x, self.train_y[idx]


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    seed: int = 0
    order: int = 1

    def __post_init__(self):
        r = np.random.RandomState(self.seed)
        v = min(self.vocab_size, 512)       # active vocabulary
        self._active = v
        # sparse-ish Markov transition: each token has ~8 likely successors
        trans = np.full((v, v), 1e-3)
        for t in range(v):
            succ = r.randint(0, v, 8)
            trans[t, succ] += r.dirichlet(np.ones(8)) * 5
        self._trans = trans / trans.sum(1, keepdims=True)

    def batches(self, batch_size: int, *, seed: int = 0,
                process_index: int = 0, process_count: int = 1
                ) -> Iterator[dict]:
        r = np.random.RandomState(seed * 1000003 + process_index)
        cum = np.cumsum(self._trans, axis=1)
        while True:
            toks = np.empty((batch_size, self.seq_len + 1), np.int32)
            toks[:, 0] = r.randint(0, self._active, batch_size)
            u = r.rand(batch_size, self.seq_len)
            for t in range(self.seq_len):
                toks[:, t + 1] = (cum[toks[:, t]] < u[:, t:t + 1]).sum(1)
            yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
