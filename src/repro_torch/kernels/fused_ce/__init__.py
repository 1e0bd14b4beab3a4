from repro_torch.kernels.fused_ce.fused_ce import FusedCEFunction, fused_ce_fwd
from repro_torch.kernels.fused_ce.ops import fused_ce
from repro_torch.kernels.fused_ce.ref import fused_ce_fwd_ref, fused_ce_ref

__all__ = ["FusedCEFunction", "fused_ce", "fused_ce_fwd", "fused_ce_fwd_ref",
           "fused_ce_ref"]
