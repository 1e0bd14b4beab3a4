from repro_torch.kernels.wagg.ops import wagg_fused_leaf, wagg_leaf
from repro_torch.kernels.wagg.ref import wagg_fused_ref, wagg_ref
from repro_torch.kernels.wagg.wagg import wagg_fused

__all__ = ["wagg_fused", "wagg_fused_leaf", "wagg_fused_ref", "wagg_leaf",
           "wagg_ref"]
