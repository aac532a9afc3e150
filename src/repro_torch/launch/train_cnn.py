"""End-to-end entry point: train the paper's CNN through the full pipeline
(fp32 -> int8 QAT -> HAPM gradual group pruning), with the HAPM epochs
after the first pruning run through a ``trainable`` bind, then check the
result on the kernels:

- executed-int8 vs QAT logits: a ``quantized`` bind of the HAPM model
  (int8 codes, int32 accumulation) against the fake-quant dense forward;
- training gradients through a ``trainable`` bind against dense autograd
  of the same masked loss, with pruned groups' gradients exactly zero.

Both trainable binds use the default contract, ``ExecSpec(trainable=True,
n_cu=12)`` (packed (128, 128) tiles, ``dense_fallback=0.999``), as the JAX
package does: only convs whose tile plan is below 0.999 dense go through
the kernels, the rest train on the dense library convolution. At HAPM
sparsity 0.5 on ``ResNetConfig()`` that is 2 of the 21 convs, both fully
pruned 1x1 projections, so the weight-gradient kernel is not launched.
Training every conv through the kernels needs ``dense_fallback=2.0``
(``make_sparse_train_step`` on such a bind, as ``chip_smoke.py`` does).

Between training and the checks it prices the int8 and the HAPM model on
the paper's three FPGA boards (``accel.simulate``, DSB on): cycle-model
figures for those boards, not times on the device the program runs on.

The twin of the JAX package's ``examples/train_cifar_hapm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_cnn            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train_cnn --device cpu --epochs 1 --train-size 256

Without ``--device`` it runs on the GPU and raises when there is none.
"""
from __future__ import annotations

import argparse

import torch

from ..accel import BOARDS, simulate
from ..core import apply_masks
from ..core import quant as Q
from ..core.masks import global_sparsity, tree_flatten_with_path
from ..data.synthetic import SyntheticCifar
from ..models import cnn
from ..train import cnn_training as CT
from ..train.loop import value_and_grad

# executed-int8 vs QAT logits: both sides' conv sums are exact integers
# below 2^24 and come out bitwise equal whenever the dense library
# convolution sums directly; the bar leaves room for one that does not
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--paper", action="store_true",
                    help="the paper's protocol: 50000 images, 200/100/60 epochs")
    ap.add_argument("--hapm-sparsity", type=float, default=0.5)
    ap.add_argument("--sparse-training", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run HAPM epochs after the first pruning step "
                         "through the block-sparse kernels")
    ap.add_argument("--device", default=None,
                    help="the GPU by default (an error without one); "
                         "'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = cnn.resolve_device(args.device)

    if args.paper:
        ds = SyntheticCifar(num_train=50000, num_test=10000)
        e = (200, 100, 60)
    else:
        ds = SyntheticCifar(num_train=args.train_size, num_test=512)
        e = (args.epochs + 2, args.epochs, args.epochs)
    steps = sum(e) * (ds.num_train // 128)
    print(f"training ~{steps} steps total on {ds.num_train} images ({dev})\n")

    m1 = CT.train_variant("fp32", ds, e[0], device=dev)
    m2 = CT.train_variant("int8", ds, e[1], init_from=m1, device=dev)
    m4 = CT.train_variant("hapm", ds, e[2], init_from=m2,
                          hapm_sparsity=args.hapm_sparsity,
                          sparse_training=args.sparse_training, device=dev)
    print(f"\nfp32 acc={m1.test_accuracy:.3f} | int8 acc={m2.test_accuracy:.3f} "
          f"| HAPM acc={m4.test_accuracy:.3f} "
          f"(weight sparsity {global_sparsity(m4.masks):.2f})")

    print("\naccelerator pricing (cycle model, DSB on):")
    imgs = torch.from_numpy(ds.test_x[:256]).to(dev)
    labels = torch.from_numpy(ds.test_y[:256]).to(dev)
    for name, board in BOARDS.items():
        r2 = simulate(m2.params, m2.state, m2.cfg, board, imgs, labels, device=dev)
        r4 = simulate(m4.params, m4.state, m4.cfg, board, imgs, labels, device=dev)
        print(f"  {name:>24}: int8 {r2.mean_time_per_image_s*1e3:6.2f} ms -> "
              f"HAPM {r4.mean_time_per_image_s*1e3:6.2f} ms "
              f"({r2.mean_time_per_image_s/r4.mean_time_per_image_s:.2f}x)")

    # --- executed sparse inference through the kernels --------------------
    print("\nexecuted sparse inference (block-sparse kernels):")
    board12 = BOARDS["zedboard_100mhz_72dsp"]          # n_cu = 12
    r12 = simulate(m4.params, m4.state, m4.cfg, board12)
    exec_ = cnn.bind_execution(
        m4.params, m4.cfg,
        spec=cnn.ExecSpec(packed=False, quantized=True, n_cu=board12.n_cu),
        device=dev)
    small, labels = imgs[:2], labels[:2]
    with torch.no_grad():
        dense_logits, _ = cnn.apply(m4.params, m4.state, small, m4.cfg)
        sparse_logits, _ = cnn.apply(m4.params, m4.state, small, m4.cfg,
                                     sparse=exec_)
    err = float(torch.max(torch.abs(sparse_logits - dense_logits)))
    code_delta = int(torch.max(torch.abs(Q.to_int(sparse_logits, Q.Q3_4)
                                         - Q.to_int(dense_logits, Q.Q3_4))))
    executed, dense_steps = exec_.step_counts(m4.cfg, batch=1)
    if not Q.f32_parity_is_exact(max(3 * 3 * c for c in m4.cfg.widths)):
        raise AssertionError("config outgrew the f32-exactness bound — "
                             "compare with a wider tolerance")
    print(f"  dispatched grid steps/image: {executed}/{dense_steps} "
          f"({executed / dense_steps:.2f} of dense) | DSB cycle ratio "
          f"{r12.dsb_cycle_ratio:.2f} | executed-int8 vs QAT "
          f"logits: max |sparse - dense| = {err:.2e}, bitwise equal: "
          f"{bool(torch.equal(sparse_logits, dense_logits))}, "
          f"max |Δ Q3.4 code| = {code_delta}")
    if err > LOGIT_TOL:
        raise AssertionError(f"executed int8 diverged from QAT: {err}")

    # --- and the training direction: gradients through the kernels --------
    # dense reference and sparse path differentiate the SAME loss, i.e.
    # through apply_masks (the train step masks before the forward)
    texec = cnn.bind_execution(
        m4.params, m4.cfg, spec=cnn.ExecSpec(trainable=True, n_cu=board12.n_cu),
        device=dev)
    tbatch = {"x": small, "y": labels}

    def grads(sparse):
        loss = lambda p: CT._loss_fn(apply_masks(p, m4.masks), m4.state,
                                     tbatch, m4.cfg, sparse)
        return value_and_grad(loss, m4.params)[1]

    gd = dict(tree_flatten_with_path(grads(None)))
    gs = dict(tree_flatten_with_path(grads(texec)))
    gerr = max(float(torch.max(torch.abs(gd[k] - gs[k]))) for k in gd)
    pruned_max = max(float(torch.max(torch.abs(gs[k] * (1 - m))))
                     for k, m in tree_flatten_with_path(m4.masks))
    print(f"  sparse-kernel training grads: max |dense - sparse| = {gerr:.2e} "
          f"| max pruned-group grad = {pruned_max:.2e}")
    if gerr > GRAD_TOL:
        raise AssertionError(f"gradient parity broke: {gerr}")
    if pruned_max != 0.0:
        raise AssertionError("pruned groups must get exactly-zero gradients")
    return m4


if __name__ == "__main__":
    main()
