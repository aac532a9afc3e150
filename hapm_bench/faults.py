"""Faults planted in the timed path underneath a run, for the tests that
show ``correct`` comes out false and for the readings of ``calibrate.py``:
each is a context manager that patches the port's entry while it is open.

- ``frozen_state``: the training step returns the weights, BN state and
  optimizer state it was given (its loss is still computed);
- ``half_batch``: the training step sees the first half of each batch, its
  mean taken over that half;
- ``altered_answer``: every answer of the server has its first frame's
  first logit moved by 0.5.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _train_step_patch(wrap):
    from repro_torch.train import cnn_training

    def make(original):
        def make_step(cfg, sparse):
            return wrap(original(cfg, sparse))
        return make_step
    return _patched(cnn_training, "make_sparse_train_step", make)


def frozen_state():
    def wrap(step):
        def frozen(params, state, opt_state, masks, batch, lr):
            loss = step(params, state, opt_state, masks, batch, lr)[3]
            return params, state, opt_state, loss
        return frozen
    return _train_step_patch(wrap)


def half_batch():
    def wrap(step):
        def half(params, state, opt_state, masks, batch, lr):
            n = batch["x"].shape[0] // 2
            return step(params, state, opt_state, masks,
                        {"x": batch["x"][:n], "y": batch["y"][:n]}, lr)
        return half
    return _train_step_patch(wrap)


def altered_answer():
    from repro_torch.launch.serve_cnn import CnnServer

    def make(original):
        def infer(self, images, **kw):
            y = original(self, images, **kw).clone()
            y[0, 0] += 0.5
            return y
        return infer
    return _patched(CnnServer, "infer", make)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
