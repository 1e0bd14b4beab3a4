"""Per-leaf entry points of the fused aggregation kernel, the counterparts
of ``repro/kernels/wagg/ops.py``: the ``pallas_wagg`` schedule
(``core/backends.py``) calls ``wagg_fused_leaf`` for every worker leaf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wagg.wagg import wagg_fused


def wagg_fused_leaf(x: torch.Tensor, payload: Optional[torch.Tensor], aux,
                    theta: torch.Tensor, beta: float,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (p, ...) leaf: codec decode + Alg. 4 mask + Eq. 10 FMA in one
    kernel pass. ``payload``/``aux`` are the codec's ``encode`` outputs
    (``payload=None``: the payload is x). The per-leaf scale ``aux`` is
    folded into theta on the device (``m = sum_j (theta_j * scale) q_j``),
    so the host never waits for it."""
    p = x.shape[0]
    theta_eff = theta.float()
    if aux is not None:
        theta_eff = theta_eff * aux.float()
    flat_q = None if payload is None else payload.reshape(p, -1)
    act = None if active is None else active.float()
    out = wagg_fused(x.reshape(p, -1), theta_eff, float(beta),
                     payload=flat_q, active=act)
    return out.reshape(x.shape)


def wagg_leaf(x: torch.Tensor, theta: torch.Tensor, beta: float,
              active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (p, ...) leaf through the fused kernel, x as its own payload."""
    return wagg_fused_leaf(x, None, None, theta, beta, active=active)
