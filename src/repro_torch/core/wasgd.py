"""The communication step of Alg. 1, the counterpart of
``repro/core/wasgd.py``: theta from the configured worker-assessment
policy, Eq. 10 through the configured aggregation spec, and the Judge
z-scores for the order search."""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core import backends
from repro_torch.core.order import judge_scores
from repro_torch.core.weights import omega, policy_from_config, theta_entropy


class CommResult(NamedTuple):
    params: Dict
    theta: torch.Tensor         # (p,)
    scores: torch.Tensor        # (p,) Judge z-scores
    metrics: Dict


def communicate(params: Dict, axes: Dict, h: torch.Tensor, wcfg,
                mesh=None, policy_state=None) -> CommResult:
    """One communication (lines 12-19 of Alg. 1). ``h``: (p,) loss
    energies of every worker. A stateful policy starts from a fresh state
    unless ``policy_state`` is given; the advanced state is returned in
    ``metrics["policy_state"]``. ``mesh`` rides in the backend context
    (the mesh schedules need it; under it ``params`` hold this shard's
    rows, ``core/shardmap_agg.py``)."""
    theta, policy_state = policy_from_config(wcfg)(h, None, policy_state)
    new_params = backends.aggregate_from_config(wcfg, params, axes, theta,
                                                mesh=mesh)
    metrics = {
        "theta_entropy": theta_entropy(theta),
        "omega": omega(theta),
        "h_mean": h.mean(),
        "h_min": h.min(),
        "policy_state": policy_state,
    }
    return CommResult(new_params, theta, judge_scores(h), metrics)
