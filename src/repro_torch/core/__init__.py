"""SparseInfer core: training-free activation-sparsity prediction (the
paper's primary contribution), the counterpart of ``repro/core``."""
from repro_torch.core.predictor import (
    AlphaSchedule,
    margins,
    mlp_macs,
    neg_counts,
    pack_signs,
    packed_width,
    predict_sparse,
    predictor_op_count,
    predictor_sign_bytes,
    unpack_signs,
)
from repro_torch.core.relufication import (get_activation, is_sparsifiable,
                                           relufy)
from repro_torch.core.selection import (
    Selection,
    SelectionStats,
    actual_sparsity_mask,
    apply_neuron_permutation,
    capacity_select,
    capacity_select_with_stats,
    coactivation_permutation,
    expected_capacity,
    group_margins,
    mask_from_selection,
    take_row_groups,
    union_margin,
)
from repro_torch.core.sparse_mlp import (
    MLP_STAT_KEYS,
    SHARD_RIDER_KEYS,
    SHARD_STAT_KEY,
    SHARD_UNION_KEY,
    SparseInferConfig,
    apply,
    dense_mlp,
    gather_mlp,
    init_gated_mlp,
    masked_mlp,
    pallas_mlp,
    prepare_sparse_params,
    zero_mlp_stats,
)
