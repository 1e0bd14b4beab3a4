"""The differentiable RMSNorm the model calls, the counterpart of
``repro/kernels/rmsnorm/ops.py``: ``models.layers.rmsnorm`` takes it by
default, on every device (``rmsnorm.py`` picks the kernel or the plain
version by the tensor's device). ``add_rmsnorm`` is the residual add and
the norm in one launch, which the model takes for every norm that follows
a residual add; ``rmsnorm.fused_add`` names it, so that a caller holding
the norm op finds its fused form (a plain norm has none)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rmsnorm.rmsnorm import (AddRMSNormFunction,
                                                 RMSNormFunction)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., d); scale: (d,). ``x * rsqrt(mean(x^2) + eps) * scale`` in
    x's dtype, differentiable in x and scale, also under ``torch.func``."""
    return RMSNormFunction.apply(x, scale, eps)[0]


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, delta: (..., d) of one dtype; scale: (d,). Returns (s = x +
    delta, exactly torch's add; ``rmsnorm(s, scale, eps)``), differentiable
    in x, delta and scale, also under ``torch.func``."""
    s, y, _ = AddRMSNormFunction.apply(x, delta, scale, eps)
    return s, y


rmsnorm.fused_add = add_rmsnorm
