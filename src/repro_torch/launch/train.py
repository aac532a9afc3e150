"""Step builders shared by the dry-run, the LM training driver and the
examples, the twin of the JAX package's ``launch/train.py``.

The ``train_step`` integrates HAPM as in the JAX package: group masks
(tiny ``(num_groups,)`` f32 tensors) ride in the step inputs and are
applied to the weights inside the step through ``apply_group_mask``'s tiled
broadcast, so no element mask is held. The loss is differentiated with
respect to the *masked* weights, which are the leaves of the gradient (the
mask is not in the graph, so a pruned entry gets its true gradient and
AdamW's moments see it); weight decay reads the unmasked weights, and the
updated weights are masked again.

PyTorch runs eagerly, so the step is a plain function. The JAX package
jits it with ``donate_argnums=(0, 1)`` and updates the weights and moments
in place; this step returns new tensors, so for a moment it holds two
copies of them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --smoke --device cpu \\
        --steps 6 --batch 4 --seq 32 --hapm-sparsity 0.25

Without ``--device`` the driver runs on the GPU and raises when there is
none.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Optional

import torch

from ..core.groups import GroupSpec, apply_group_mask
from ..core.masks import tree_leaves, tree_map
from ..models import lm
from ..models.lm_config import LMConfig
from ..train import optimizer as OPT
from ..train.loop import value_and_grad

PyTree = Any


def _spec_or_none(x) -> bool:
    return x is None or isinstance(x, GroupSpec)


def expand_group_masks(group_specs: PyTree, gmasks: PyTree) -> PyTree:
    """Group masks -> element masks (f32, the weights' shapes); ``None``
    where a weight has no groups."""
    def f(spec, gm):
        if not isinstance(spec, GroupSpec):
            return None
        return spec.expand(gm)
    return tree_map(f, group_specs, gmasks, is_leaf=_spec_or_none)


def init_group_masks(group_specs: PyTree, device=None) -> PyTree:
    """All-ones ``(num_groups,)`` f32 masks on ``device`` (the CPU unless
    given; ``"meta"`` for shapes only), ``None`` elsewhere."""
    return tree_map(
        lambda s: (torch.ones((s.num_groups,), dtype=torch.float32, device=device)
                   if isinstance(s, GroupSpec) else None),
        group_specs, is_leaf=_spec_or_none)


def build_train_step(cfg: LMConfig, group_specs: Optional[PyTree] = None,
                     lr: float = 3e-4, weight_decay: float = 0.1,
                     accum_unroll: int = 1, opt_moment_dtype=torch.float32):
    """-> (train_step(params, opt_state, gmasks, batch) -> (params',
    opt_state', loss), opt_init).

    With ``cfg.grad_accum = A > 1`` the batch splits into A micro-batches
    along its leading dim; their gradients are summed in f32 and divided by
    A, and the loss is their mean. With A = 1 the gradients keep the
    weights' dtype until AdamW casts them. ``accum_unroll`` is the JAX
    package's unroll of its micro-batch scan; a Python loop has none, so it
    is accepted and changes nothing."""
    del accum_unroll
    opt_init, opt_update = OPT.adamw(weight_decay=weight_decay,
                                     moment_dtype=opt_moment_dtype)
    A = max(cfg.grad_accum, 1)

    @torch.no_grad()
    def mask_params(params, gmasks):
        def f(spec, p, gm):
            if not isinstance(spec, GroupSpec):
                return p
            return apply_group_mask(spec, p, gm)
        return tree_map(f, group_specs, params, gmasks, is_leaf=_spec_or_none)

    def lf(p, b):
        return lm.loss_fn(p, b, cfg)

    def train_step(params, opt_state, gmasks, batch):
        mp = mask_params(params, gmasks) if group_specs is not None else params
        if A == 1:
            (loss, _), grads = value_and_grad(lf, mp, batch)
        else:
            micro = {k: None if v is None else v.reshape(A, v.shape[0] // A, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                                   device=p.device), mp)
            loss = 0.0
            for a in range(A):
                (l, _), g = value_and_grad(
                    lf, mp, {k: None if v is None else v[a] for k, v in micro.items()})
                tree_map(lambda s, b: s.add_(b.to(s.dtype)), grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g.div_(A), grads)
            loss = loss / A
        updates, new_opt = opt_update(grads, opt_state, params, lr)
        del grads
        params = OPT.apply_updates(params, updates)
        if group_specs is not None:
            params = mask_params(params, gmasks)
        return params, new_opt, loss

    return train_step, opt_init


def build_prefill(cfg: LMConfig):
    def prefill_fn(params, batch):
        return lm.prefill(params, batch, cfg)
    return prefill_fn


def build_decode(cfg: LMConfig):
    def decode_fn(params, caches, token, pos):
        return lm.decode_step(params, caches, token, pos, cfg)
    return decode_fn


# ---------------------------------------------------------------------------
# Training driver (host-scale demo of the production path)
# ---------------------------------------------------------------------------

def group_masks_on(hstate, device) -> PyTree:
    """HAPM's host masks (numpy) as f32 tensors on ``device``."""
    return tree_map(lambda m: None if m is None else torch.as_tensor(m, device=device),
                    hstate.group_masks, is_leaf=lambda x: x is None)


def main(argv=None):
    from ..configs import registry
    from ..core import HAPMConfig, hapm_epoch_update, hapm_group_sparsity, hapm_init
    from ..data.synthetic import TokenStream
    from ..models.cnn import resolve_device
    from ..train import checkpoint as CKPT

    ap = argparse.ArgumentParser(description="LM training driver (HAPM-integrated)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hapm-sparsity", type=float, default=0.0)
    ap.add_argument("--hapm-epochs", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; \"cpu\" asks for the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.config_for(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    params = lm.init(0, cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    specs = lm.group_specs(params, cfg)
    train_step, opt_init = build_train_step(cfg, specs, lr=args.lr)
    opt_state = opt_init(params)

    hapm_cfg = HAPMConfig(args.hapm_sparsity, args.hapm_epochs)
    hstate = hapm_init(specs, hapm_cfg)
    gmasks = group_masks_on(hstate, dev)

    start = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        skeleton = {"params": params, "opt": opt_state}
        tree, meta = CKPT.restore(args.ckpt_dir, skeleton, device=dev)
        params, opt_state = tree["params"], tree["opt"]
        start = meta["step"] + 1
        print(f"resumed from step {meta['step']}")

    ds = TokenStream(cfg.vocab_size, args.seq)
    it = ds.batches(args.batch, seed=1)
    steps_per_epoch = max(args.steps // max(args.hapm_epochs, 1), 1)
    for step in range(start, args.steps):
        if args.hapm_sparsity > 0 and step % steps_per_epoch == 0:
            hstate = hapm_epoch_update(hstate, specs, params, hapm_cfg)
            gmasks = group_masks_on(hstate, dev)
            print(f"  [hapm] epoch {hstate.epoch}: group sparsity "
                  f"{hapm_group_sparsity(hstate):.3f}")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, loss = train_step(params, opt_state, gmasks, batch)
        if step % args.log_every == 0:
            print(f"step {step}: loss={float(loss):.4f}")
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, step, {"params": params, "opt": opt_state})
    print(f"final loss: {float(loss):.4f}")


if __name__ == "__main__":
    main()
