"""The program's HAPM pruning of a configuration: the port's own
``hapm_init`` and ``hapm_epoch_update`` over the conv weights' schedule
groups, one epoch update that prunes the whole ``group_sparsity``."""
from __future__ import annotations

from repro_torch.core import (HAPMConfig, apply_masks, hapm_element_masks,
                              hapm_epoch_update, hapm_init)
from repro_torch.core.masks import tree_map
from repro_torch.models import cnn


def prune(params: dict, pruning: dict) -> dict:
    """{"params": the pruned tree, "group_masks": the HAPM group masks
    (params-shaped), "element_masks": the element masks (params-shaped,
    ``None`` off the convs)}."""
    specs = cnn.conv_group_specs(params, pruning["n_cu"])
    hcfg = HAPMConfig(pruning["group_sparsity"], epochs=1)
    state = hapm_epoch_update(hapm_init(specs, hcfg), specs, params, hcfg)
    device = params["conv0"]["w"].device
    elem = tree_map(lambda m: m.to(device), hapm_element_masks(specs, state))
    return {"params": apply_masks(params, elem), "group_masks": state.group_masks,
            "element_masks": elem}
