"""Quickstart: the paper's pipeline in under a minute.

1. Build the 21-conv ResNet, form HAPM groups from the accelerator schedule.
2. Prune 50% of groups (one-shot here; gradual in ``launch.train_cnn``).
3. Price inference on the paper's Zedboard config with/without DSB (cycle
   model: times for the FPGA board, not for the device this runs on).

The twin of the JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart                # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Without ``--device`` it runs on the GPU and raises when there is none.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..accel import BOARDS, simulate
from ..core import (HAPMConfig, apply_masks, hapm_element_masks,
                    hapm_epoch_update, hapm_group_sparsity, hapm_init)
from ..core.masks import tree_map
from ..models import cnn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the GPU by default (an error without one); 'cpu' "
                         "runs on the CPU")
    args = ap.parse_args(argv)
    dev = cnn.resolve_device(args.device)

    cfg = cnn.ResNetConfig()
    params, state = cnn.init(0, cfg, device=dev)
    board = BOARDS["zedboard_100mhz_72dsp"]
    print(f"model: 21-conv ResNet ({cnn.network_ops(cfg, params)/1e9:.4f} GOP/img); "
          f"board: {board.dsps} DSPs @ {board.freq_mhz:.0f} MHz ({dev})")

    # HAPM: groups = the weights one schedule step processes together
    specs = cnn.conv_group_specs(params, board.n_cu)
    hcfg = HAPMConfig(target_group_sparsity=0.5, epochs=1)
    hstate = hapm_init(specs, hcfg)
    print(f"schedule analysis: {hstate.total_groups} groups "
          f"(= (f_block, g) steps across all layers)")

    hstate = hapm_epoch_update(hstate, specs, params, hcfg)
    masks = tree_map(lambda m: m.to(dev), hapm_element_masks(specs, hstate))
    pruned = apply_masks(params, masks)
    print(f"pruned {hapm_group_sparsity(hstate):.0%} of groups")

    base = simulate(params, state, cfg, board)
    fast = simulate(pruned, state, cfg, board)
    no_dsb = simulate(pruned, state, cfg, dataclasses.replace(board, dsb=False))
    print(f"\ninference time per image (cycle model):")
    print(f"  dense    + DSB : {base.mean_time_per_image_s*1e3:7.2f} ms  "
          f"({base.gops:5.2f} GOPs)")
    print(f"  HAPM 50% + DSB : {fast.mean_time_per_image_s*1e3:7.2f} ms  "
          f"({fast.gops:5.2f} GOPs)  <- {base.mean_time_per_image_s/fast.mean_time_per_image_s:.2f}x")
    print(f"  HAPM 50% no DSB: {no_dsb.mean_time_per_image_s*1e3:7.2f} ms  "
          f"(sparsity useless without the bypass hardware)")
    return base, fast, no_dsb


if __name__ == "__main__":
    main()
