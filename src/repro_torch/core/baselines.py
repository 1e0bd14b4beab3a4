"""The paper's baselines (Sec. 5.2.2) as communication rules over a
worker-stacked parameter tree, the counterpart of
``repro/core/baselines.py``. They share the WASGD round (local steps, then
a communication), so a comparison isolates the rule:

* ``spsgd``: SimuParallelSGD, the equal-weight average.
* ``easgd``: Elastic Averaging SGD, a center variable with moving rate
  alpha (Eqs. 3-4).
* ``omwu``/``mmwu``: multiplicative weight update; every worker adopts
  the parameters of the worker with the largest weight. Both run on the
  m-sample energies here, as in the JAX package.
* sequential SGD: workers that never talk (``train/step.py::no_comm_rule``).

Under a device mesh (``mesh=``; ``core/shardmap_agg.py``) the params are
this rank's worker rows and every other state is the same on every rank:
SPSGD's average is the all-reduce of the theta-weighted local sums,
EASGD's center (no worker axis) moves by the all-reduced sum of the
ranks' deltas, and under MWU the argmax worker's rows are broadcast from
the rank that holds them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import aggregate as agg
from repro_torch.core import shardmap_agg as smagg
from repro_torch.core.weights import equal_weights
from repro_torch.tree import tree_leaves, tree_map


def _n_workers(params: Dict, axes: Dict) -> int:
    return next(x.shape[0] for x, ax in zip(tree_leaves(params),
                                            tree_leaves(axes))
                if agg.is_worker_leaf(ax))


# -- SimuParallelSGD ----------------------------------------------------------

def spsgd_communicate(params: Dict, axes: Dict) -> Dict:
    theta = equal_weights(_n_workers(params, axes),
                          tree_leaves(params)[0].device)
    return agg.weighted_aggregate(params, axes, theta, beta=1.0)


def adopt_aggregate(params: Dict, axes: Dict, theta: torch.Tensor,
                    mesh=None) -> Dict:
    """Eq. 10 at beta 1: every worker adopts ``sum_j theta_j x_j``; under
    ``mesh`` through the all-reduce of the theta-weighted local sums."""
    if mesh is None:
        return agg.weighted_aggregate(params, axes, theta, beta=1.0)
    return agg.map_worker_leaves(
        lambda x: smagg.aggregate_leaf_shard_map(x, theta, 1.0, mesh),
        params, axes)


# -- EASGD --------------------------------------------------------------------

class EASGDState(NamedTuple):
    center: Dict                 # x~: the params' structure, no worker dim


def easgd_init(params: Dict, axes: Dict) -> EASGDState:
    return EASGDState(tree_map(
        lambda x, ax: x[0].clone() if agg.is_worker_leaf(ax) else x,
        params, axes))


def easgd_communicate(params: Dict, axes: Dict, state: EASGDState,
                      alpha: float, mesh=None) -> Tuple[Dict, EASGDState]:
    """The Eq. 3 elastic pull and the Eq. 4 center update (the
    communication part only), in float32, cast back to each leaf's
    dtype. Under ``mesh`` the center moves by the all-reduced sum of the
    ranks' deltas."""
    def upd(x, ax, c):
        if not agg.is_worker_leaf(ax):
            return x, c
        delta = alpha * (x.float() - c.float()[None])
        moved = delta.sum(0)
        if mesh is not None:
            smagg.all_reduce_(moved, mesh)
        return ((x.float() - delta).to(x.dtype),
                (c.float() + moved).to(c.dtype))

    pairs = tree_map(upd, params, axes, state.center)
    return (tree_map(lambda t: t[0], pairs),
            EASGDState(tree_map(lambda t: t[1], pairs)))


# -- Multiplicative weight update -----------------------------------------------

class MWUState(NamedTuple):
    log_w: torch.Tensor          # (p,) log multiplicative weights


def mwu_init(p: int, device=None) -> MWUState:
    return MWUState(torch.zeros(p, dtype=torch.float32, device=device))


def mwu_theta(log_w: torch.Tensor) -> torch.Tensor:
    """One-hot on the largest weight (the first on a tie, as
    ``jnp.argmax``)."""
    return torch.nn.functional.one_hot(
        torch.argmax(log_w), log_w.shape[0]).float()


def mwu_communicate(params: Dict, axes: Dict, state: MWUState,
                    h: torch.Tensor, eps: float = 0.5, mesh=None
                    ) -> Tuple[Dict, MWUState]:
    """``w_i <- w_i * exp(-eps * h'_i)`` with ``h' = h / sum(h)``; every
    worker adopts the argmax worker's parameters. ``h`` and the weights
    are every worker's; under ``mesh`` the argmax worker's rows are
    broadcast from the rank that holds them and each worker takes them
    through the same FMA as without a mesh, so the params are the
    meshless ones."""
    hp = h.float() / torch.clamp_min(h.sum(), 1e-30)
    log_w = state.log_w - eps * hp
    if mesh is None:
        new_params = agg.weighted_aggregate(params, axes, mwu_theta(log_w),
                                            beta=1.0)
    else:
        k = int(torch.argmax(log_w))
        new_params = agg.map_worker_leaves(
            lambda x: agg.fma_late_join(x, smagg.broadcast_row(x, k, mesh),
                                        1.0), params, axes)
    return new_params, MWUState(log_w)
