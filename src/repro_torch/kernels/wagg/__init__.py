from repro_torch.kernels.wagg.ops import (aggregate_tree_wagg,
                                          wagg_fused_leaf, wagg_fused_leaves,
                                          wagg_leaf)
from repro_torch.kernels.wagg.ref import wagg_fused_ref, wagg_ref
from repro_torch.kernels.wagg.wagg import wagg_fused, wagg_fused_many

__all__ = ["aggregate_tree_wagg", "wagg_fused", "wagg_fused_leaf",
           "wagg_fused_leaves", "wagg_fused_many", "wagg_fused_ref",
           "wagg_leaf", "wagg_ref"]
