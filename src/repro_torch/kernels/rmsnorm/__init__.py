from repro_torch.kernels.rmsnorm.ops import add_rmsnorm, rmsnorm
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_fwd_ref,
                                             add_rmsnorm_ref, rmsnorm_fwd_ref,
                                             rmsnorm_ref)
from repro_torch.kernels.rmsnorm.rmsnorm import (AddRMSNormFunction,
                                                 RMSNormFunction,
                                                 add_rmsnorm_fwd, rmsnorm_fwd)

__all__ = ["AddRMSNormFunction", "RMSNormFunction", "add_rmsnorm",
           "add_rmsnorm_fwd", "add_rmsnorm_fwd_ref", "add_rmsnorm_ref",
           "rmsnorm", "rmsnorm_fwd", "rmsnorm_fwd_ref", "rmsnorm_ref"]
