"""Weighted aggregation, the paper's communication step (Eq. 10):

    x_i  <-  (1 - beta) * x_i  +  beta * sum_j theta_j * x_j

applied to every parameter leaf that carries the leading ``worker``
dimension; leaves without one pass through. The counterpart of
``repro/core/aggregate.py``. The axes tree (a tuple of logical axis names
per leaf, ``("worker", ...)`` for worker-stacked leaves) is plain Python
data and decides which leaves aggregate. The aggregation specs of
``core/backends.py`` are built on these helpers.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.tree import tree_map


def is_worker_leaf(axes_leaf) -> bool:
    return isinstance(axes_leaf, tuple) and len(axes_leaf) > 0 \
        and axes_leaf[0] == "worker"


def fma_late_join(x: torch.Tensor, m: torch.Tensor, beta,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The worker-local half of Eq. 10, ``(1-beta) x + beta m``, plus the
    Alg. 4 late-join: inactive workers (``active`` False or 0) adopt the
    aggregate ``m``."""
    out = (1.0 - beta) * x.float() + beta * m[None]
    if active is not None:
        mask = active if active.dtype == torch.bool else active != 0
        mask = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out = torch.where(mask, out, m[None].expand_as(out))
    return out.to(x.dtype)


def aggregate_leaf(x: torch.Tensor, theta: torch.Tensor, beta
                   ) -> torch.Tensor:
    """One (w, ...) leaf in float32: tensordot over the worker axis, then
    the FMA."""
    agg = torch.tensordot(theta.float(), x.float(), dims=1)
    return fma_late_join(x, agg, beta)


def weighted_aggregate(params: Dict, axes: Dict, theta: torch.Tensor, beta,
                       leaf_fn: Optional[Callable] = None) -> Dict:
    """Eq. 10 on every worker leaf of ``params``; ``leaf_fn(x, theta,
    beta)`` replaces the float32 per-leaf computation. (The JAX function's
    ``quantize``/``comm_dtype``/``n_pods`` keywords are legacy forms of the
    ``schedule:codec`` specs in ``core/backends.py``.)"""
    fn = leaf_fn if leaf_fn is not None else aggregate_leaf
    return map_worker_leaves(lambda x: fn(x, theta, beta), params, axes)


def map_worker_leaves(fn: Callable, params: Dict, axes: Dict) -> Dict:
    return tree_map(lambda x, ax: fn(x) if is_worker_leaf(ax) else x,
                    params, axes)


def worker_in_axes(axes: Dict) -> Dict:
    """``vmap`` in_dims tree: 0 for worker leaves, None for shared ones."""
    return tree_map(lambda ax: 0 if is_worker_leaf(ax) else None, axes)


def strip_worker_axis(axes: Dict) -> Dict:
    """The axes tree of one worker's slice."""
    return tree_map(lambda ax: tuple(ax[1:]) if is_worker_leaf(ax) else ax,
                    axes)


def resize_worker_leaves(params: Dict, axes: Dict, new_p: int,
                         theta: Optional[torch.Tensor] = None) -> Dict:
    """Every worker leaf grown or shrunk to ``new_p`` rows, with the
    membership slot contract (``core/membership.py``): worker ``i`` keeps
    row ``i`` bitwise for ``i < min(old_p, new_p)``, a shrink drops the
    tail, and a grow appends newcomers whose row is the aggregate
    ``m = sum_j theta_j x_j`` of the survivors (``theta=None``: equal
    weights), the state an Alg. 4 late-joiner adopts. Shared leaves pass
    through."""
    if new_p < 1:
        raise ValueError(f"resize needs new_p >= 1, got {new_p}")

    def visit(x, ax):
        if not is_worker_leaf(ax):
            return x
        old_p = x.shape[0]
        if new_p <= old_p:
            return x[:new_p]
        t = (torch.full((old_p,), 1.0 / old_p, dtype=torch.float32,
                        device=x.device) if theta is None
             else theta.float())
        m = torch.tensordot(t, x.float(), dims=1)
        newcomers = m.unsqueeze(0).expand(new_p - old_p, *x.shape[1:])
        return torch.cat([x, newcomers.to(x.dtype)])

    return tree_map(visit, params, axes)


def take_worker(params: Dict, axes: Dict, i: int) -> Dict:
    """Worker ``i``'s parameter copy."""
    return tree_map(lambda x, ax: x[i] if is_worker_leaf(ax) else x,
                    params, axes)


def replicate_workers(params: Dict, axes: Dict, n_workers: int,
                      expert_copies: bool = False):
    """Single-copy params -> (w, ...) worker copies, and the axes tree with
    ``"worker"`` prepended. Expert leaves stay single-copy unless
    ``expert_copies``."""
    def stays(ax):
        return not expert_copies and isinstance(ax, tuple) \
            and "experts" in ax

    new_params = tree_map(
        lambda x, ax: x if stays(ax) else
        x.unsqueeze(0).expand(n_workers, *x.shape).contiguous(),
        params, axes)
    new_axes = tree_map(lambda ax: ax if stays(ax) else ("worker",) + ax,
                        axes)
    return new_params, new_axes


def shared_axes(params: Dict) -> Dict:
    """An axes tree that names no axis of any leaf (every leaf one shared
    copy), as the paper models' harness builds it."""
    return tree_map(lambda x: (None,) * x.dim(), params)
