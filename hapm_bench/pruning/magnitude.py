"""The program's uniform magnitude pruning of a configuration: the port's
``magnitude_masks`` at the configured sparsity on every conv weight."""
from __future__ import annotations

from repro_torch.core import apply_masks, full_masks, magnitude_masks
from repro_torch.models import cnn


def prune(params: dict, pruning: dict) -> dict:
    """{"params", "group_masks": None (derived from the zero slabs at bind),
    "element_masks"}."""
    masks = magnitude_masks(params, full_masks(params, cnn.is_conv_weight),
                            pruning["sparsity"])
    return {"params": apply_masks(params, masks), "group_masks": None,
            "element_masks": masks}
