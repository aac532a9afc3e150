"""A configuration made concrete for the program (the port's
``ResNetConfig``, its pruning of the raw weights) and for the reference
(its masks), each pruning found by its kind: ``pruning/<kind>.py`` for the
program, ``reference/prune_<kind>.py`` for the reference."""
from __future__ import annotations

import importlib


def resnet_config(config: dict, quantized: bool = False):
    from repro_torch.models import cnn
    m = config["model"]
    return cnn.ResNetConfig(stages=tuple(m["stages"]), widths=tuple(m["widths"]),
                            num_classes=m["num_classes"], in_channels=m["in_channels"],
                            image_size=m["image_size"], quantized=quantized,
                            bn_eps=m["bn_eps"])


def program_pruning(config: dict, params: dict) -> dict:
    kind = config["pruning"]["kind"]
    return importlib.import_module(f"hapm_bench.pruning.{kind}").prune(
        params, config["pruning"])


def reference_masks(config: dict, params: dict) -> dict:
    kind = config["pruning"]["kind"]
    return importlib.import_module(f"hapm_bench.reference.prune_{kind}").masks(
        params, config["model"], config["pruning"])
