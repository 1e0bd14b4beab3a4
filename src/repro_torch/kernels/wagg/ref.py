"""Plain PyTorch versions of the fused Eq. 10 aggregation kernel.

Same signatures and semantics as ``repro/kernels/wagg/ref.py``: a
tensordot over the worker axis in float32, the FMA against the original
``x``, and the Alg. 4 late-join mask. The CPU path of the port runs them,
and ``chip_smoke.py`` holds the CUDA kernel to ``wagg_fused_ref`` on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch


def wagg_ref(x: torch.Tensor, theta: torch.Tensor, beta: float
             ) -> torch.Tensor:
    """out[i] = (1-beta) x[i] + beta * sum_j theta[j] x[j]."""
    xf = x.float()
    agg = torch.tensordot(theta.float(), xf, dims=1)
    return ((1.0 - beta) * xf + beta * agg[None]).to(x.dtype)


def wagg_fused_ref(x: torch.Tensor, theta: torch.Tensor, beta: float,
                   payload: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The aggregate is taken over ``payload`` widened to float32 (the
    codec's per-leaf scale already folded into ``theta``), the FMA against
    the original ``x``, and inactive rows (``active == 0``) adopt the
    aggregate. ``payload=None`` means the payload is ``x``."""
    xf = x.float()
    src = xf if payload is None else payload.float()
    m = torch.tensordot(theta.float(), src, dims=1)
    out = (1.0 - beta) * xf + beta * m[None]
    if active is not None:
        out = torch.where(active[:, None] != 0, out, m[None].expand_as(out))
    return out.to(x.dtype)
