from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_fwd_ref, rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import RMSNormFunction, rmsnorm_fwd

__all__ = ["RMSNormFunction", "rmsnorm", "rmsnorm_fwd", "rmsnorm_fwd_ref",
           "rmsnorm_ref"]
