"""Plain PyTorch versions of the RMSNorm kernel.

``rmsnorm_ref`` has the signature and semantics of
``repro/kernels/rmsnorm/ref.py``: ``x * rsqrt(mean(x^2, -1) + eps) *
scale``, the reduction in float32 (float64 for float64 inputs, which
the gradient checks use), the output in x's dtype.
``rmsnorm_fwd_ref`` is the kernel's own contract, which also returns the
per-row ``rstd`` the backward pass reads and takes a scale per group of
rows. ``add_rmsnorm_fwd_ref`` is the fused launch's contract: the residual
sum ``s = x + delta`` (torch's add, rounded once to x's dtype), then the
norm of ``s``. The CPU path of the port runs them, and ``chip_smoke.py``
holds the CUDA kernel to them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation type: float32, or float64 for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    xf = acc(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * acc(scale)).to(x.dtype)


def group_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``scale`` (d,) as it is, or (G, d) for x (G, ..., d) reshaped to
    (G, 1, ..., 1, d) so that it broadcasts over each group's rows."""
    if scale.dim() == 1:
        return scale
    return scale.reshape(scale.shape[0], *([1] * (x.dim() - 2)),
                         scale.shape[1])


def rmsnorm_fwd_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d); scale: (d,), or (G, d) with x (G, ..., d): group g's
    rows take scale[g]. Returns (y in x's dtype, rstd (...,) float32)."""
    xf = acc(x)
    rstd = torch.rsqrt(xf.square().mean(dim=-1) + eps)
    y = (xf * rstd[..., None] * acc(group_scale(scale, x))).to(x.dtype)
    return y, rstd


def add_rmsnorm_fwd_ref(x: torch.Tensor, delta: torch.Tensor,
                        scale: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, delta: (..., d) of one dtype; scale as ``rmsnorm_fwd_ref``.
    Returns (s = x + delta, y = the norm of s, rstd (...,) float32)."""
    s = x + delta
    y, rstd = rmsnorm_fwd_ref(s, scale, eps)
    return s, y, rstd


def add_rmsnorm_ref(x: torch.Tensor, delta: torch.Tensor,
                    scale: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, its RMSNorm): the plain version of the fused op."""
    s = x + delta
    return s, rmsnorm_ref(s, scale, eps)
