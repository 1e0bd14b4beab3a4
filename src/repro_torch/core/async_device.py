"""On-device asynchronous WASGD+ (paper Alg. 4) through the aggregation
specs, the counterpart of ``repro/core/async_device.py``.

``core/async_sim.py`` simulates Alg. 4's scheduling on the host; here the
p-of-(p+b) round runs on the workers' device, the round's activity a
``(w,)`` mask:

    local steps -> loss energies -> masked theta (stragglers exactly 0)
    -> Eq. 10 over the ACTIVE workers through any ``schedule:codec`` spec
    -> late-join: inactive workers adopt the aggregate m = sum_j theta_j x_j

Every ported schedule applies the late-join when ``ctx.active`` is set
(``None``: all active, the synchronous update); under ``pallas_wagg`` the
CUDA ``wagg_fused`` applies it in its pass. The port has no jit: a round
is a plain function of torch tensors. The mask of a round is checked for
an active worker on the host, in numpy (``validate_active_rounds``),
before it goes to the device, and the round casts it to float32 once for
every leaf's kernel.

Under a device mesh (``ctx.mesh``; ``core/shardmap_agg.py``) each rank
holds its shard's worker rows of the params and the batch, and steps
them; the round gathers the per-worker losses (and, measured, the
times) over the worker group, so every rank forms the same theta, the
same mask and the same policy state, and aggregates through the spec's
collectives.

Measured-time mode (``run_parallel_sgd_on_device(measure_times=True)``)
derives the mask from measured round times. Each process times its own
local steps (the device synchronized, the host clock), and under a mesh
the times are all-gathered, so the stable first-p rule sees one arrival
per shard. Without a mesh every worker is one ``vmap``ped program on one
device and gets the same time, and the rule picks workers 0..p-1, as the
JAX package does on one host device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backends
from repro_torch.core import shardmap_agg as smagg
from repro_torch.core import weights as weights_mod
from repro_torch.core.async_sim import (AsyncResult, StepTimeModel,
                                        StragglerSchedule, batch_on,
                                        make_schedule, stack_workers,
                                        worker_axes)
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

ASYNC_BACKENDS = ("async_einsum", "async_shard_map", "async_rs_ag")

# legacy sync backend -> its Alg. 4 alias
_ASYNC_OF = {"einsum": "async_einsum", "shard_map": "async_shard_map",
             "rs_ag": "async_rs_ag"}


def async_backend_name(name: str) -> str:
    """A (possibly synchronous) backend name or spec -> its Alg. 4 form:
    the legacy names map to their ``async_*`` aliases, any other spec to
    its canonical ``schedule:codec`` (every schedule applies the mask).
    An unknown name raises ``ValueError``."""
    if name in ASYNC_BACKENDS:
        return name
    if name in _ASYNC_OF:
        return _ASYNC_OF[name]
    try:
        backends.resolve_spec(name)
    except KeyError:
        raise ValueError(
            f"aggregation backend {name!r} has no async (Alg. 4) "
            f"counterpart; use a composed 'schedule:codec' spec, one of "
            f"{sorted(_ASYNC_OF)}, or {sorted(ASYNC_BACKENDS)}")
    return backends.canonical_spec(name)


def validate_active_rounds(active: np.ndarray, rounds: Optional[int] = None):
    """Rejects a straggler schedule with an all-False round (its masked
    theta would be NaN and its round loss the mean of an empty slice), on
    the host, before any round runs."""
    active = np.asarray(active, bool)
    if rounds is not None:
        active = active[:rounds]
    empty = np.flatnonzero(~active.any(axis=-1))
    if empty.size:
        raise ValueError(
            f"straggler schedule has no active worker in round(s) "
            f"{empty.tolist()}: an all-straggler round has no Alg. 4 "
            f"aggregate to late-join (masked theta would be NaN and the "
            f"round loss the mean of an empty slice); every round needs "
            f">= 1 active worker")


def resize_active_mask(active: torch.Tensor, new_p: int) -> torch.Tensor:
    """The Alg. 4 mask after a membership resize (``core/membership.py``):
    worker ``i`` keeps slot ``i`` for ``i < min(old_p, new_p)``, a shrink
    drops the tail, newcomers join active. A shrink that leaves no active
    worker raises ``no_active_error``."""
    if new_p < 1:
        raise ValueError(f"resize needs new_p >= 1, got {new_p}")
    active = active.bool()
    old_p = active.shape[0]
    if new_p <= old_p:
        out = active[:new_p]
        weights_mod._reject_all_false(out)
        return out
    return torch.cat([active, torch.ones(new_p - old_p, dtype=torch.bool,
                                         device=active.device)])


# schedule keyword of the pre-two-axis API -> composed backend name
_SCHEDULE_NAMES = {"einsum": "einsum", "all_reduce": "shard_map:f32",
                   "rs_ag": "rs_ag"}


def weighted_aggregate_async(params: Dict, axes: Dict, theta: torch.Tensor,
                             active: Optional[torch.Tensor], beta,
                             mesh=None, schedule: str = "all_reduce",
                             comm_dtype=torch.float32) -> Dict:
    """The masked Eq. 10 and late-join on every worker leaf. ``schedule``
    ``"einsum"`` (meshless), ``"all_reduce"`` (an all-reduce over
    ``mesh``'s worker group) or ``"rs_ag"`` (reduce-scatter + FMA +
    all-gather over it); the two mesh schedules raise ``ValueError``
    without a mesh."""
    if schedule not in _SCHEDULE_NAMES:
        raise ValueError(f"unknown async schedule {schedule!r}; "
                         f"known: {sorted(_SCHEDULE_NAMES)}")
    if active is None:
        active = torch.ones(theta.shape, dtype=torch.bool,
                            device=theta.device)
    ctx = backends.AggregationContext(mesh=mesh, comm_dtype=comm_dtype,
                                      active=active)
    return backends.aggregate_with(_SCHEDULE_NAMES[schedule], params, axes,
                                   theta, beta, ctx=ctx)


def _resolve_backend(backend: str, ctx):
    name = async_backend_name(backend)
    backend_obj = backends.get_backend(name)
    if getattr(backend_obj, "needs_mesh", False) and ctx.mesh is None:
        raise ValueError(
            f"async aggregation backend {name!r} places explicit "
            f"collectives and needs ctx.mesh (AggregationContext(mesh=...))")
    return backend_obj


def _resolve_policy(policy, strategy: str, a_tilde: float):
    """``policy`` wins; ``None`` takes the legacy ``strategy``/``a_tilde``
    kernel (an unknown strategy raises the listing error)."""
    if policy is None:
        weights_mod.validate_config_spec(strategy)
        return weights_mod.parse_policy(strategy, default_a=a_tilde)
    return weights_mod.as_policy(policy, default_a=a_tilde)


def gather_losses(losses: torch.Tensor, mesh) -> torch.Tensor:
    """Every worker's ``(w,)`` losses from this shard's rows (a mesh),
    or ``losses`` as they are (none)."""
    return losses if mesh is None else smagg.gather_rows(losses, mesh)


def _masked_aggregate(backend_obj, pol, ctx, w_axes, beta):
    """theta and the Eq. 10 + late-join of one round; the mask is cast to
    float32 once, for every leaf. ``losses`` are every worker's."""
    def agg(params, losses, active, pstate):
        theta, pstate = pol(losses, active, pstate, checked=True)
        params = backend_obj.aggregate(
            params, w_axes, theta, beta,
            ctx=dataclasses.replace(ctx, active=active.float()))
        return params, theta, pstate
    return agg


def build_async_round(grad_fn: Callable, axes: Dict, *, lr: float,
                      beta: float = 0.9, a_tilde: float = 1.0,
                      strategy: str = "boltzmann",
                      policy=None,
                      backend: str = "async_shard_map",
                      ctx: Optional[backends.AggregationContext] = None
                      ) -> Callable:
    """One p-of-(p+b) round. Stateless policy:
    ``round_fn(params, batch, active) -> (params, losses, theta)``;
    stateful: ``round_fn(params, batch, active, pstate) -> (params, losses,
    theta, pstate)`` (``round_fn.stateful`` says which). ``active`` is a
    ``(w,)`` bool mask already checked for an active worker.
    ``grad_fn(params_stacked, batch) -> (losses (w,), grads_stacked)``.
    Under ``ctx.mesh`` the params and the batch are this shard's rows and
    the returned losses every worker's."""
    ctx = backends.DEFAULT_CONTEXT if ctx is None else ctx
    pol = _resolve_policy(policy, strategy, a_tilde)
    agg = _masked_aggregate(_resolve_backend(backend, ctx), pol, ctx,
                            worker_axes(axes), beta)

    def _advance(params, batch, active, pstate):
        losses, grads = grad_fn(params, batch)
        params = tree_map(lambda p, g: p - lr * g, params, grads)
        del grads
        losses = gather_losses(losses, ctx.mesh)
        params, theta, pstate = agg(params, losses, active, pstate)
        return params, losses, theta, pstate

    if pol.stateful:
        def round_fn(params, batch, active, pstate):
            return _advance(params, batch, active, pstate)
    else:
        def round_fn(params, batch, active):
            return _advance(params, batch, active, ())[:3]
    round_fn.stateful = pol.stateful
    return round_fn


def build_split_async_round(grad_fn: Callable, axes: Dict, *, lr: float,
                            beta: float = 0.9,
                            policy="boltzmann",
                            backend: str = "async_einsum",
                            ctx: Optional[backends.AggregationContext]
                            = None) -> Tuple[Callable, Callable]:
    """The round split where measured-time mode takes its measurement:
    ``local_fn(params, batch) -> (params, losses)`` (the local steps) and
    ``agg_fn(params, losses, active, pstate) -> (params, theta, pstate)``
    (masked theta, Eq. 10 and the late-join; ``losses`` every worker's,
    ``gather_losses`` under a mesh)."""
    ctx = backends.DEFAULT_CONTEXT if ctx is None else ctx
    pol = weights_mod.as_policy(policy)
    agg_fn = _masked_aggregate(_resolve_backend(backend, ctx), pol, ctx,
                               worker_axes(axes), beta)

    def local_fn(params, batch):
        losses, grads = grad_fn(params, batch)
        return tree_map(lambda p, g: p - lr * g, params, grads), losses

    return local_fn, agg_fn


def measure_round_times(x: torch.Tensor, w: int, mesh=None,
                        t0: Optional[float] = None) -> np.ndarray:
    """Measured completion time of each worker's rows of ``x``: the host
    clock, from ``t0`` (default: now), once this process's device has
    produced ``x``. Its rows share that time; under a mesh each shard's
    time is all-gathered (the JAX package's per-device times), so every
    rank holds the same ``(w,)`` times. Without one, all ``w`` workers
    get the one time."""
    t0 = time.perf_counter() if t0 is None else t0
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt = time.perf_counter() - t0
    if mesh is None:
        return np.full((w,), dt)
    shards = smagg.mesh_worker_shards(mesh)
    mine = torch.full((1,), dt, dtype=torch.float64, device=x.device)
    per_shard = smagg.gather_rows(mine, mesh).cpu().numpy()
    return np.repeat(per_shard, w // shards)


def run_parallel_sgd_on_device(grad_fn: Callable, params0: Dict, axes: Dict,
                               batches, *, n_workers: int, backups: int,
                               tau: int, rounds: int, lr: float,
                               time_model: Optional[StepTimeModel] = None,
                               schedule: Optional[StragglerSchedule] = None,
                               measure_times: bool = False,
                               a_tilde: float = 1.0, beta: float = 0.9,
                               strategy: str = "boltzmann",
                               policy=None,
                               synchronous: bool = False,
                               backend: str = "async_shard_map",
                               ctx: Optional[backends.AggregationContext]
                               = None, device=None) -> AsyncResult:
    """The on-device counterpart of ``async_sim.run_parallel_sgd``: the
    same schedule semantics (inject the same ``schedule`` to compare), each
    round on ``device`` (``None``: cuda, raising without a card) through
    the ``backend`` spec. ``params0`` and each batch are moved there.

    ``measure_times=True`` derives each round's mask from measured round
    times instead (no ``time_model`` or ``schedule``): the round splits
    after its local steps (``build_split_async_round``), the first
    ``n_workers`` arrivals aggregate, and the times feed the policy's
    ``observe_times`` (``time_aware``). ``AsyncResult.round_times`` holds
    them; ``wall`` sums each round's p-th arrival.

    Under ``ctx.mesh`` each rank steps its shard's rows of the params and
    of every batch (batches hold every worker's rows) and the losses and
    times are all-gathered, so every rank forms the same masks, theta and
    losses; ``AsyncResult.params`` holds this rank's rows."""
    dev = resolve_device(device)
    w = n_workers + backups
    pol = _resolve_policy(policy, strategy, a_tilde)
    mesh = None if ctx is None else ctx.mesh
    params = stack_workers(tree_map(lambda x: x.to(dev), params0), w)
    if mesh is not None:
        rows = smagg.local_rows(w, mesh)
        params = tree_map(lambda x: x[rows].contiguous(), params)

    def next_batch():
        batch = next(batches)                      # (w, tau*b_local, ...)
        if mesh is not None:
            batch = tree_map(lambda x: x[rows], batch)
        return batch_on(batch, dev)

    if measure_times:
        if schedule is not None or time_model is not None:
            raise ValueError(
                "measure_times=True derives the activity schedule from "
                "measured per-device round times; don't pass time_model= "
                "or schedule= as well")
        local_fn, agg_fn = build_split_async_round(
            grad_fn, axes, lr=lr, beta=beta, policy=pol, backend=backend,
            ctx=ctx)
        pstate = pol.init_state(w, dev)
        losses_hist, times_hist = [], []
        wall = 0.0
        dropped = 0
        for r in range(rounds):
            batch = next_batch()
            # Without a mesh the clock starts after dispatch and times the
            # wait, as JAX's does. Under one each rank's clock covers its
            # own dispatch too: a gloo (CPU) rank runs its local steps
            # synchronously, so only then does it see its own step time.
            t0 = None if mesh is None else time.perf_counter()
            params, losses = local_fn(params, batch)
            times = measure_round_times(losses, w, mesh=mesh, t0=t0)
            losses = gather_losses(losses, mesh)
            order = np.argsort(times, kind="stable")
            active = np.zeros((w,), bool)
            active[order[:n_workers]] = True       # first p arrivals
            wall += float(times[order[n_workers - 1]])
            dropped += int(backups)
            pstate = pol.observe_times(pstate, times)
            params, _, pstate = agg_fn(
                params, losses, torch.as_tensor(active, device=dev), pstate)
            losses_hist.append(float(losses.cpu().numpy()[active].mean()))
            times_hist.append(times)
        return AsyncResult(np.asarray(losses_hist), wall, dropped, params,
                           np.asarray(times_hist))

    if schedule is None:
        if time_model is None:
            raise ValueError("pass either time_model= or schedule= "
                             "(or measure_times=True)")
        schedule = make_schedule(time_model, rounds=rounds, tau=tau,
                                 n_workers=n_workers, backups=backups,
                                 synchronous=synchronous)
    validate_active_rounds(schedule.active, rounds=rounds)
    round_fn = build_async_round(grad_fn, axes, lr=lr, beta=beta,
                                 a_tilde=a_tilde, strategy=strategy,
                                 policy=pol, backend=backend, ctx=ctx)
    pstate = pol.init_state(w, dev)
    masks = torch.as_tensor(np.asarray(schedule.active[:rounds], bool),
                            device=dev)

    losses_hist = []
    for r in range(rounds):
        batch = next_batch()
        if round_fn.stateful:
            params, losses, _, pstate = round_fn(params, batch, masks[r],
                                                 pstate)
        else:
            params, losses, _ = round_fn(params, batch, masks[r])
        losses_np = losses.cpu().numpy()
        losses_hist.append(float(losses_np[schedule.active[r]].mean()))

    wall = float(schedule.round_wall[:rounds].sum())
    dropped = int((~schedule.active[:rounds]).sum())
    return AsyncResult(np.asarray(losses_hist), wall, dropped, params)
