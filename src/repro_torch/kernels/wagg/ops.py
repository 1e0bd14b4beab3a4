"""Leaf and tree entry points of the fused aggregation kernel, the
counterparts of ``repro/kernels/wagg/ops.py``: the ``pallas_wagg``
schedule (``core/backends.py``) hands ``wagg_fused_leaves`` every worker
leaf of a tree at once, which runs them in grouped launches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.kernels.wagg.wagg import wagg_fused_many


def wagg_fused_leaves(xs: Sequence[torch.Tensor], payloads: Sequence,
                      auxs: Sequence, theta: torch.Tensor, beta,
                      active: Optional[torch.Tensor] = None
                      ) -> List[torch.Tensor]:
    """(p, ...) leaves: codec decode + Alg. 4 mask + Eq. 10 FMA, every leaf
    in one kernel pass, the leaves in grouped launches. ``payloads``/
    ``auxs`` are the codec's ``encode`` outputs per leaf (a payload None:
    the payload is x). Each per-leaf scale ``aux`` is folded into theta on
    the device (``m = sum_j (theta_j * scale) q_j``), so the host never
    waits for it."""
    p = theta.shape[0]
    flat_q = [None if q is None else q.reshape(p, -1) for q in payloads]
    act = None if active is None else active.float()
    outs = wagg_fused_many([x.reshape(p, -1) for x in xs], theta.float(),
                           float(beta), payloads=flat_q, scales=list(auxs),
                           active=act)
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]


def wagg_fused_leaf(x: torch.Tensor, payload: Optional[torch.Tensor], aux,
                    theta: torch.Tensor, beta,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (p, ...) leaf through ``wagg_fused_leaves``."""
    return wagg_fused_leaves([x], [payload], [aux], theta, beta,
                             active=active)[0]


def wagg_leaf(x: torch.Tensor, theta: torch.Tensor, beta,
              active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (p, ...) leaf through the fused kernel, x as its own payload."""
    return wagg_fused_leaf(x, None, None, theta, beta, active=active)


def aggregate_tree_wagg(params, axes, theta: torch.Tensor, beta):
    """Eq. 10 on every worker leaf of ``params`` (x its own payload), all
    of them in grouped launches: the meshless ``pallas_wagg:f32``
    aggregate. Other leaves come back as they are."""
    from repro_torch.core.backends import get_backend
    return get_backend("pallas_wagg:f32").aggregate(params, axes, theta,
                                                    beta)
