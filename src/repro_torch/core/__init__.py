"""The WASGD core of the port: energies, the order search, worker
assessment, payload codecs, Eq. 10 and the aggregation specs (over a
``torch.distributed`` device mesh too), Alg. 4 straggler rounds and
elastic membership."""
from repro_torch.core.aggregate import (fma_late_join, is_worker_leaf,
                                        map_worker_leaves, replicate_workers,
                                        resize_worker_leaves, shared_axes,
                                        strip_worker_axis, take_worker,
                                        weighted_aggregate, worker_in_axes)
from repro_torch.core.async_device import (ASYNC_BACKENDS, async_backend_name,
                                           build_async_round,
                                           build_split_async_round,
                                           measure_round_times,
                                           run_parallel_sgd_on_device,
                                           weighted_aggregate_async)
from repro_torch.core.async_sim import StragglerSchedule, make_schedule
from repro_torch.core.backends import (AggregationContext, ComposedBackend,
                                       aggregate_from_config, aggregate_with,
                                       available_backends, available_codecs,
                                       available_schedules, available_specs,
                                       backend_name_from_config,
                                       canonical_spec, context_from_config,
                                       get_backend, register_backend,
                                       register_schedule, resolve_spec,
                                       select_auto_spec, worker_leaf_bytes)
from repro_torch.core.codecs import get_codec
from repro_torch.core.energy import (estimation_error, record_indices,
                                     record_mask)
from repro_torch.core.membership import (MembershipEvent, MembershipSchedule,
                                         WorkerSet, make_chaos_schedule,
                                         resize_comm_state, resize_opt_state,
                                         resize_train_state)
from repro_torch.core.order import OrderState, grouped_order, judge_scores
from repro_torch.core.wasgd import CommResult, communicate
from repro_torch.core.weights import (as_policy, compute_theta,
                                      masked_compute_theta, omega,
                                      parse_policy, policy_from_config,
                                      theta_entropy)

__all__ = [
    "ASYNC_BACKENDS", "AggregationContext", "CommResult",
    "ComposedBackend", "MembershipEvent", "MembershipSchedule",
    "OrderState", "StragglerSchedule", "WorkerSet",
    "aggregate_from_config", "aggregate_with", "as_policy",
    "async_backend_name", "available_backends", "available_codecs",
    "available_schedules", "available_specs", "backend_name_from_config",
    "build_async_round", "build_split_async_round", "canonical_spec",
    "communicate", "compute_theta", "context_from_config",
    "estimation_error", "fma_late_join",
    "get_backend", "get_codec", "grouped_order", "is_worker_leaf",
    "judge_scores", "make_chaos_schedule", "make_schedule",
    "map_worker_leaves", "masked_compute_theta", "measure_round_times",
    "omega", "parse_policy", "policy_from_config", "record_indices",
    "record_mask", "register_backend", "register_schedule",
    "replicate_workers", "resize_comm_state", "resize_opt_state",
    "resize_train_state", "resize_worker_leaves", "resolve_spec",
    "run_parallel_sgd_on_device", "select_auto_spec", "shared_axes",
    "strip_worker_axis", "take_worker", "theta_entropy",
    "weighted_aggregate", "weighted_aggregate_async", "worker_in_axes",
    "worker_leaf_bytes",
]
