"""Beyond-paper example: HAPM tile pruning on a transformer LM, then its
pruned FFN served through the block-sparse matmul kernel (K1, the GPU's
Dynamic Sparsity Bypass). The twin of the JAX package's
``examples/prune_lm_blocksparse.py``.

Trains a small LM for a few hundred steps with gradual HAPM tile pruning,
then swaps layer 0's pruned FFN matmul onto the block-sparse kernel
(``kernels/ops.py::make_block_sparse_matmul``) and checks it against the
masked-dense product.

    PYTHONPATH=src python -m repro_torch.launch.prune_lm_blocksparse --device cpu [--steps 120]

Without ``--device`` it runs on the GPU (the kernel launches there) and
raises when there is none; on the CPU the kernel's wrapper runs its plain
PyTorch version.
"""
import argparse
import dataclasses

import numpy as np
import torch

from ..core import HAPMConfig, hapm_epoch_update, hapm_group_sparsity, hapm_init
from ..core.groups import GroupSpec, apply_group_mask
from ..core.masks import tree_leaves, tree_map
from ..data.synthetic import TokenStream
from ..kernels import ops
from ..models import lm
from ..models.cnn import resolve_device
from ..models.lm_config import LMConfig
from ..sparse.block_mask import plan_from_tile_mask
from .train import build_train_step, group_masks_on, init_group_masks

DEMO_CFG = LMConfig("demo-lm", "dense", num_layers=2, d_model=256, num_heads=4,
                    num_kv_heads=2, d_ff=512, vocab_size=512, remat="none",
                    dtype="float32", block_size=(128, 128))
KERNEL_TOL = 1e-4       # kernel vs masked-dense, max abs (the JAX example's bar)


def layer_spec(spec, layer_masks):
    """The one-layer spec of a stacked weight's spec (its leading layer dim
    dropped), and that layer's ``(nKb, nNb)`` group masks."""
    one = dataclasses.replace(spec, shape=spec.shape[1:], _meta=(spec.block, spec.tiles[1:]),
                              num_groups=int(np.prod(spec.tiles[1:])))
    return one, np.asarray(layer_masks).reshape(spec.tiles)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the GPU; \"cpu\" asks for the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = DEMO_CFG
    params = lm.init(0, cfg, device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {n/1e6:.2f}M params; HAPM tile groups of {cfg.block_size}")

    specs = lm.group_specs(params, cfg)
    hcfg = HAPMConfig(args.sparsity, args.epochs)
    hstate = hapm_init(specs, hcfg)
    n_specs = sum(1 for s in tree_leaves(specs, is_leaf=lambda x: isinstance(x, GroupSpec)))
    print(f"{hstate.total_groups} tile groups across {n_specs} weight matrices")

    train_step, opt_init = build_train_step(cfg, specs, lr=1e-3)
    opt_state = opt_init(params)
    ds = TokenStream(cfg.vocab_size, seq_len=64)
    it = ds.batches(16, seed=0)

    steps_per_epoch = max(args.steps // args.epochs, 1)
    gmasks = init_group_masks(specs, device=dev)
    for step in range(args.steps):
        if step % steps_per_epoch == 0:
            hstate = hapm_epoch_update(hstate, specs, params, hcfg)
            gmasks = group_masks_on(hstate, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, loss = train_step(params, opt_state, gmasks, batch)
        if step % 20 == 0:
            print(f"  step {step:4d}: loss={float(loss):.4f} "
                  f"group-sparsity={hapm_group_sparsity(hstate):.2f}")
    print(f"final loss {float(loss):.4f}, "
          f"tile sparsity {hapm_group_sparsity(hstate):.2f}")

    # ---- serve the pruned FFN through the block-sparse kernel ----
    print("\nswapping pruned FFN matmuls onto the block-sparse kernel:")
    blk = tree_map(lambda t: t[0], params["blocks"])          # layer 0
    spec_wi, gm_wi = layer_spec(specs["blocks"]["ffn"]["wi"],
                                hstate.group_masks["blocks"]["ffn"]["wi"])
    gm_wi = gm_wi[0]
    w_masked = apply_group_mask(spec_wi, blk["ffn"]["wi"],
                                torch.from_numpy(gm_wi.reshape(-1)))
    plan = plan_from_tile_mask(gm_wi > 0, spec_wi.block)
    f = ops.make_block_sparse_matmul(plan, gm_wi > 0)
    x = torch.from_numpy(np.random.RandomState(3).randn(64, cfg.d_model)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        y_kernel = f(x, blk["ffn"]["wi"])
        y_ref = x @ w_masked
    err = float((y_kernel - y_ref).abs().max())
    print(f"  layer0 wi: {plan.skipped_tiles}/{plan.tiles[0]*plan.tiles[1]} tiles "
          f"skipped; kernel-vs-masked-dense max err = {err:.2e}")
    print(f"  grid steps per output column: {plan.max_nnz} (dense: {plan.tiles[0]})")
    if not err < KERNEL_TOL:
        raise AssertionError(f"kernel vs masked-dense max err {err} (bar {KERNEL_TOL})")
    return {"loss": float(loss), "sparsity": hapm_group_sparsity(hstate), "err": err,
            "skipped_tiles": plan.skipped_tiles, "y_kernel": y_kernel,
            "w": blk["ffn"]["wi"], "tile_mask": gm_wi > 0, "x": x}


if __name__ == "__main__":
    main()
