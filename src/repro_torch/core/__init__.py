"""The WASGD core of the port: energies, the order search, worker
assessment, payload codecs, Eq. 10 and the aggregation specs."""
from repro_torch.core.aggregate import (fma_late_join, is_worker_leaf,
                                        map_worker_leaves, replicate_workers,
                                        shared_axes, take_worker,
                                        weighted_aggregate, worker_in_axes)
from repro_torch.core.backends import (AggregationContext, ComposedBackend,
                                       aggregate_from_config, aggregate_with,
                                       backend_name_from_config,
                                       context_from_config, get_backend,
                                       resolve_spec)
from repro_torch.core.codecs import get_codec
from repro_torch.core.energy import record_indices, record_mask
from repro_torch.core.order import OrderState, grouped_order, judge_scores
from repro_torch.core.wasgd import CommResult, communicate
from repro_torch.core.weights import (compute_theta, masked_compute_theta,
                                      omega, parse_policy, policy_from_config,
                                      theta_entropy)

__all__ = [
    "AggregationContext", "CommResult", "ComposedBackend", "OrderState",
    "aggregate_from_config", "aggregate_with", "backend_name_from_config",
    "communicate", "compute_theta", "context_from_config", "fma_late_join",
    "get_backend", "get_codec", "grouped_order", "is_worker_leaf",
    "judge_scores", "map_worker_leaves", "masked_compute_theta", "omega",
    "parse_policy", "policy_from_config", "record_indices", "record_mask",
    "replicate_workers", "resolve_spec", "shared_axes", "take_worker",
    "theta_entropy", "weighted_aggregate", "worker_in_axes",
]
