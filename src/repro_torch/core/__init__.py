"""HAPM core: schedule-derived group pruning, baselines, quantization."""
from .groups import (
    GroupSpec,
    FpgaConvGroupSpec,
    TpuTileGroupSpec,
    FlatGroupSpec,
    fpga_conv_groups,
    tpu_tile_groups,
    flat_groups,
    apply_group_mask,
)
from .hapm import (
    HAPMConfig,
    HAPMState,
    hapm_init,
    hapm_epoch_update,
    hapm_element_masks,
    hapm_group_sparsity,
    hapm_scores,
)
from .masks import (
    apply_masks,
    full_masks,
    global_sparsity,
    per_leaf_sparsity,
    sparsity,
    count_params,
)
from .uniform import UniformPruneConfig, magnitude_masks, maybe_update, sparsity_at
from .quant import (QFormat, Q2_5, Q3_4, QuantSpec, quantize, fake_quant,
                    round_sat, to_int, to_int8, from_int)
