"""The differentiable RMSNorm the model calls, the counterpart of
``repro/kernels/rmsnorm/ops.py``: ``models.layers.rmsnorm`` takes it by
default, on every device (``rmsnorm.py`` picks the kernel or the plain
version by the tensor's device)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.rmsnorm import RMSNormFunction


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., d); scale: (d,). ``x * rsqrt(mean(x^2) + eps) * scale`` in
    x's dtype, differentiable in x and scale, also under ``torch.func``."""
    return RMSNormFunction.apply(x, scale, eps)[0]
