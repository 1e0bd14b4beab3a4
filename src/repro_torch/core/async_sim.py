"""Asynchronous WASGD+ (paper Alg. 4) as an event-driven simulation, the
counterpart of ``repro/core/async_sim.py``.

p + b workers with per-worker step-time distributions: at each
communication the FIRST p round results aggregate (Alg. 4 line 16), and
the b slowest workers of the round adopt the aggregate late. The
scheduling (``StepTimeModel``, ``make_schedule``) is numpy, drawn from
``default_rng`` as the JAX package draws it, so both packages make the
same schedule from the same seed. ``run_parallel_sgd`` advances real
parameters in torch, on the device of its inputs, and is the oracle that
``core/async_device.run_parallel_sgd_on_device`` is held to.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backends
from repro_torch.core import weights as weights_mod
from repro_torch.core.aggregate import is_worker_leaf
from repro_torch.core.weights import compute_theta, no_active_error
from repro_torch.tree import tree_leaves, tree_map


def masked_theta(losses: np.ndarray, active: np.ndarray,
                 a_tilde: float = 1.0, strategy: str = "boltzmann"
                 ) -> np.ndarray:
    """theta over the p active workers of a p-of-(p+b) round, 0 for the
    stragglers. The inactive workers are left out before the energies are
    normalized, so they cannot flatten the active workers' weights. An
    all-False mask raises ``no_active_error``."""
    losses = np.asarray(losses)
    active = np.asarray(active, bool)
    if active.size and not active.any():
        raise no_active_error()
    theta_active = compute_theta(
        torch.as_tensor(losses[active], dtype=torch.float32), strategy,
        a_tilde).numpy()
    theta = np.zeros(losses.shape[0], np.float32)
    theta[active] = theta_active
    return theta / theta.sum()


class StepTimeModel:
    """Per-worker step-time sampler: lognormal base + straggler spikes."""

    def __init__(self, n_workers: int, mean: float = 1.0, sigma: float = 0.1,
                 straggle_p: float = 0.0, straggle_mult: float = 10.0,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.n = n_workers
        self.mean, self.sigma = mean, sigma
        self.straggle_p, self.straggle_mult = straggle_p, straggle_mult

    def round_times(self, tau: int) -> np.ndarray:
        """Simulated wall-time for each worker to finish tau local steps."""
        t = self.rng.lognormal(np.log(self.mean), self.sigma,
                               size=(self.n, tau))
        spikes = self.rng.random((self.n, tau)) < self.straggle_p
        t = np.where(spikes, t * self.straggle_mult, t)
        return t.sum(axis=1)


class StragglerSchedule(NamedTuple):
    """A precomputed p-of-(p+b) activity schedule, so the same straggler
    pattern can drive this simulation and the on-device round."""
    active: np.ndarray          # (rounds, w) bool: round r's aggregation set
    round_wall: np.ndarray      # (rounds,) simulated gate time per round


def make_schedule(time_model: StepTimeModel, *, rounds: int, tau: int,
                  n_workers: int, backups: int = 0,
                  synchronous: bool = False) -> StragglerSchedule:
    """Alg. 4: the first ``n_workers`` arrivals of each round form the
    aggregation set and the p-th arrival gates the round's wall time.
    Alg. 1 (``synchronous``): everyone is active, the slowest gates."""
    w = n_workers + backups
    active = np.ones((rounds, w), bool)
    round_wall = np.zeros(rounds)
    for r in range(rounds):
        t = time_model.round_times(tau)
        if synchronous:
            round_wall[r] = t.max()
        else:
            order = np.argsort(t)
            active[r] = False
            active[r, order[:n_workers]] = True    # first p arrivals
            round_wall[r] = t[order[n_workers - 1]]
    return StragglerSchedule(active, round_wall)


class AsyncResult(NamedTuple):
    losses: np.ndarray          # per-round mean loss over the active workers
    wall: float                 # simulated (or measured) wall-clock
    dropped_rounds: int         # total straggler exclusions
    params: Optional[Dict] = None       # final worker-stacked params
    round_times: Optional[np.ndarray] = None
                                # (rounds, w) measured round times
                                # (run_parallel_sgd_on_device with
                                # measure_times=True), else None


def stack_workers(params0: Dict, w: int) -> Dict:
    """Single-copy params -> ``w`` contiguous worker rows per leaf."""
    return tree_map(lambda x: x.unsqueeze(0).expand(w, *x.shape)
                    .contiguous(), params0)


def worker_axes(axes: Dict) -> Dict:
    return tree_map(lambda ax: ("worker",) + tuple(ax), axes)


def batch_on(batch: Dict, device) -> Dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run_parallel_sgd(loss_fn: Callable, grad_fn: Callable, params0: Dict,
                     axes: Dict, batches, *, n_workers: int, backups: int,
                     tau: int, rounds: int, lr: float,
                     time_model: Optional[StepTimeModel] = None,
                     a_tilde: float = 1.0,
                     beta: float = 0.9, synchronous: bool = False,
                     strategy: str = "boltzmann",
                     policy=None,
                     backend: str = "einsum",
                     schedule: Optional[StragglerSchedule] = None,
                     ctx: Optional[backends.AggregationContext] = None
                     ) -> AsyncResult:
    """Alg. 4 (``synchronous=False``: the p fastest of p+b aggregate) or
    Alg. 1 (a barrier over all workers), one SGD step a round on the
    round's ``(w, tau * b_local, ...)`` batch. Runs on the device of
    ``params0``; each batch is moved there.

    ``grad_fn(params_stacked, batch) -> (losses (w,), grads_stacked)``.
    ``backend`` is the aggregation spec applying Eq. 10 with the masked
    theta (``ctx`` its knobs); the stragglers then adopt the aggregate,
    written out here as ``sum_j theta_j new_j``. ``policy`` (a spec or a
    ``PipelinePolicy``) replaces ``strategy``/``a_tilde``, its state
    threading across rounds; ``None`` takes ``masked_theta`` on the host.
    ``schedule`` replaces ``time_model`` with a precomputed schedule.
    """
    ctx = backends.DEFAULT_CONTEXT if ctx is None else ctx
    if schedule is None:
        if time_model is None:
            raise ValueError("pass either time_model= or schedule=")
        schedule = make_schedule(time_model, rounds=rounds, tau=tau,
                                 n_workers=n_workers, backups=backups,
                                 synchronous=synchronous)
    w = n_workers + backups
    dev = tree_leaves(params0)[0].device
    pol = (None if policy is None
           else weights_mod.as_policy(policy, default_a=a_tilde))
    pstate = pol.init_state(w, dev) if pol is not None else None
    params = stack_workers(params0, w)
    w_axes = worker_axes(axes)

    wall = 0.0
    dropped = 0
    losses_hist = []
    for r in range(rounds):
        batch = batch_on(next(batches), dev)       # (w, tau*b_local, ...)
        losses, grads = grad_fn(params, batch)
        params = tree_map(lambda p, g: p - lr * g, params, grads)

        active = np.asarray(schedule.active[r], bool)
        wall += float(schedule.round_wall[r])
        dropped += int((~active).sum())
        losses_np = losses.detach().cpu().numpy()

        if pol is None:
            theta = torch.as_tensor(
                masked_theta(losses_np, active, a_tilde, strategy),
                device=dev)
        else:
            if not active.any():
                raise no_active_error()
            theta, pstate = pol(losses, torch.as_tensor(active, device=dev),
                                pstate, checked=True)
            theta = theta.float()
        new_params = backends.aggregate_with(backend, params, w_axes, theta,
                                             beta, ctx=ctx)
        # stragglers adopt the aggregate when they arrive (late join)
        act = torch.as_tensor(active, device=dev)

        def late_join(new, ax):
            if not is_worker_leaf(ax):
                return new
            m = torch.tensordot(theta, new.float(), dims=1)[None]
            mask = act.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(mask, new, m.to(new.dtype))

        params = tree_map(late_join, new_params, w_axes)
        losses_hist.append(float(np.mean(losses_np[active])))
    return AsyncResult(np.asarray(losses_hist), wall, dropped, params)
