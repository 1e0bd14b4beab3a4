"""One WASGD round: ``tau`` per-worker local SGD steps followed by one
communication, the counterpart of ``repro/train/step.py``.

    rule(params, axes, h, comm_state) -> (params, comm_state, theta, metrics)

Shape contract: every batch leaf has leading dim B = p * tau * b_local,
laid out worker-major; it is reshaped to (p, tau, b_local, ...) and then
swapped to (tau, p, b_local, ...), so step t hands worker w its own
samples. Per-worker gradients come from autograd through
``torch.func.vmap`` of the loss over the worker-stacked parameters (or
the loss's own worker-stacked form where it has one, ``StackedLoss``:
the LM loss, whose layers ``cfg.remat`` checkpoints): each worker's
gradient of its own loss (the JAX package takes the gradient of the mean
over workers and scales it by p; the two agree up to rounding).

Under a device mesh (``mesh=``; ``core/shardmap_agg.py``) each rank runs
the round on its shard's worker rows: the params, the optimizer state,
the energies and the batch (its rows of the worker-major batch, leading
dim ``B / S``) are that shard's. The energies, and every per-worker
metric, are all-gathered over the worker group before the policy, so
every rank computes the same theta, policy state, Judge scores and
metrics, and the aggregate runs through the spec's collectives. A leaf
without the worker axis (JAX's one-copy ``ep_data`` experts) is whole on
every rank: its gradient, each rank's sum over its workers, is summed
over the worker group in place and divided by the worker count, the
gradient of the mean loss over every worker as JAX takes it, the same
bits on every rank, so every rank applies the same update to its copy.
Over a mesh axis other than the worker axes (``"model"``) each index runs
this round alone, a replica.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
import types
from typing import (Callable, Dict, Optional, Protocol, Tuple,
                    runtime_checkable)

import torch
from torch.func import vmap

from repro_torch.core import aggregate as agg
from repro_torch.core import async_device
from repro_torch.core import backends
from repro_torch.core import baselines as bl
from repro_torch.core import shardmap_agg as smagg
from repro_torch.core.energy import record_mask
from repro_torch.core.order import judge_scores
from repro_torch.core.weights import (compute_theta, omega,
                                      policy_from_config, theta_entropy)
from repro_torch.device import fence
from repro_torch.obs.spans import span
from repro_torch.optim import Optimizer
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves, tree_map

LossFn = Callable[[Dict, Dict], Tuple[torch.Tensor, Dict]]


@runtime_checkable
class StackedLoss(Protocol):
    """A loss with its own worker-stacked form (``train.lm.LMLoss``), which
    the round calls in place of ``vmap(loss)``: params worker-stacked as
    ``in_dims`` says, batch leaves (p, ...) -> (losses (p,), aux)."""

    def __call__(self, params: Dict, batch: Dict
                 ) -> Tuple[torch.Tensor, Dict]: ...

    def stacked(self, params: Dict, in_dims: Dict, batch: Dict
                ) -> Tuple[torch.Tensor, Dict]: ...


def _check_pods(wcfg, name: str) -> None:
    try:
        sched = backends.resolve_spec(name)[0]
    except KeyError:
        return                               # a monolithic registration
    if sched == "hierarchical" and wcfg.n_pods < 2:
        raise ValueError("'hierarchical' aggregation schedule needs "
                         f"WASGDConfig.n_pods >= 2 (got {wcfg.n_pods})")


def _needs_mesh_check(name: str, mesh, where: str) -> None:
    backend = backends.get_backend(name)
    if getattr(backend, "needs_mesh", False) and mesh is None:
        raise ValueError(
            f"aggregation backend {backend.name!r} needs a mesh; pass "
            f"mesh= through {where}")


def wasgd_rule(wcfg, mesh=None,
               overlap: Optional[Callable] = None) -> Callable:
    """Eq. 10 communication rule: theta from the configured policy (its
    state is ``comm_state``), the aggregate through the configured
    ``schedule:codec`` spec (``"auto"`` resolves per parameter tree).
    Unknown specs, and a mesh spec without ``mesh``, fail here, when the
    rule is built. ``h`` is every worker's energies; under ``mesh`` the
    params are this shard's rows.

    ``overlap`` is a nullary thunk (its result any tree) that runs inside
    the aggregate, after every leaf's first reduce phase
    (``ComposedBackend.aggregate``); its result is ``metrics["overlap"]``
    and never feeds the aggregate, so the params are the same with or
    without it. The rule also takes a per-call ``overlap=`` keyword over
    the built one: the pipelined round hands each round a fresh seam
    thunk that way."""
    name = backends.backend_name_from_config(wcfg)
    if name != "auto":
        _needs_mesh_check(name, mesh, "Trainer/build_train_step/wasgd_rule")
        _check_pods(wcfg, name)
    pol = policy_from_config(wcfg)

    def rule(params, axes, h, comm_state, overlap=overlap):
        theta, comm_state = pol(h, None, comm_state)
        res = backends.aggregate_from_config(wcfg, params, axes, theta,
                                             mesh=mesh, overlap=overlap)
        if overlap is not None:
            new_params, overlap_out = res
            return new_params, comm_state, theta, {"overlap": overlap_out}
        return res, comm_state, theta, {}
    return rule


def async_wasgd_rule(wcfg, mesh=None,
                     overlap: Optional[Callable] = None) -> Callable:
    """Alg. 4 (p-of-(p+b)) rule for ``async_mode="on_device"``.
    ``comm_state`` is the round's ``(w,)`` bool activity mask, or
    ``{"active": mask, "policy": state}`` for a stateful policy; the host
    loop puts each round's mask in it, checked for an active worker
    (``Trainer.run(straggler_schedule=)``). theta is masked (stragglers
    exactly 0); the aggregate and the late-join run through the
    configured spec's Alg. 4 form (``async_device.async_backend_name``)
    with the mask cast to float32 once a round, which is also
    ``metrics["active"]``. ``overlap`` as in ``wasgd_rule`` (built-in
    thunk, per-call keyword); ``mesh`` too (the mask is every worker's).
    ``"auto"`` resolves per tree among the specs with a masked path."""
    name = backends.backend_name_from_config(wcfg)
    if name != "auto":
        name = async_device.async_backend_name(name)
        _needs_mesh_check(name, mesh, "Trainer/build_train_step/"
                                      "async_wasgd_rule")
        _check_pods(wcfg, name)
    pol = policy_from_config(wcfg)
    ctx = backends.context_from_config(wcfg, mesh)

    def rule(params, axes, h, comm_state, overlap=overlap):
        if pol.stateful:
            active, pstate = comm_state["active"], comm_state["policy"]
        else:
            active, pstate = comm_state, ()
        theta, pstate = pol(h, active, pstate, checked=True)
        act = active.float()
        metrics = {"active": act}
        nm = name
        if nm == "auto":
            nm = async_device.async_backend_name(backends.select_auto_spec(
                params, axes, mesh, n_pods=wcfg.n_pods, require_mask=True))
        res = backends.aggregate_with(
            nm, params, axes, theta, wcfg.beta,
            ctx=dataclasses.replace(ctx, active=act), overlap=overlap)
        if overlap is not None:
            res, metrics["overlap"] = res
        out_comm = ({"active": active, "policy": pstate} if pol.stateful
                    else comm_state)
        return res, out_comm, theta, metrics
    return rule


def spsgd_rule(mesh=None) -> Callable:
    """Equal theta, beta 1; under ``mesh`` the all-reduce of the
    theta-weighted local sums (``core/baselines.py``, as each rule
    below)."""
    def rule(params, axes, h, comm_state):
        theta = compute_theta(h, "equal")
        new_params = bl.adopt_aggregate(params, axes, theta, mesh)
        return new_params, comm_state, theta, {}
    return rule


def easgd_rule(alpha: float, mesh=None) -> Callable:
    def rule(params, axes, h, comm_state):
        new_params, new_center = bl.easgd_communicate(params, axes,
                                                      comm_state, alpha,
                                                      mesh=mesh)
        return new_params, new_center, compute_theta(h, "equal"), {}
    return rule


def mwu_rule(eps: float = 0.5, mesh=None) -> Callable:
    def rule(params, axes, h, comm_state):
        new_params, new_state = bl.mwu_communicate(params, axes, comm_state,
                                                   h, eps, mesh=mesh)
        return new_params, new_state, bl.mwu_theta(new_state.log_w), {}
    return rule


def no_comm_rule() -> Callable:
    """beta = 0, the sequential limit: workers never talk."""
    def rule(params, axes, h, comm_state):
        return params, comm_state, compute_theta(h, "equal"), {}
    return rule


PIPELINE_MODES = ("parity", "speculative")


def _round_parts(loss_fn: LossFn, optimizer: Optimizer, axes: Dict, wcfg,
                 n_workers: int, mesh=None) -> types.SimpleNamespace:
    """The round's building blocks: batch reshape, the tau-step local
    loop, per-worker losses and L2 norms, and the state/metrics assembly,
    shared by the fused round, the pipelined round and the phase-fenced
    round (``build_phased_train_step``): the three run the same code.
    Under ``mesh`` the params and batches are this shard's
    ``n_local`` worker rows, and ``gather`` collects every worker's
    values of a per-worker vector."""
    n_local = smagg.local_workers(n_workers, mesh)

    def gather(x):
        return x if mesh is None else smagg.gather_rows(x, mesh)

    in_dims = agg.worker_in_axes(axes)
    tau = wcfg.tau
    mask = record_mask(tau, wcfg.m_estimate, wcfg.record_chunks)
    if isinstance(loss_fn, StackedLoss):
        def worker_losses(params, mb):
            return loss_fn.stacked(params, in_dims, mb)
    else:
        worker_losses = vmap(loss_fn, in_dims=(in_dims, 0))

    def worker_grads(params, mb):
        """Per-worker gradients and losses (p,). Autograd runs through the
        vmapped loss: worker w's loss reads only worker w's slice of a
        worker leaf, so the gradient of the summed losses holds each
        worker's own gradient. A shared leaf (no worker axis) receives the
        sum of the workers' gradients, divided by p: their mean, as the
        gradient of the mean loss gives it in the JAX package; under a mesh
        the sum is this shard's, all-reduced over the worker group first.
        (``vmap(torch.func.grad_and_value(loss))`` gives the same
        gradients, but runs its backward with ``create_graph=True``, which
        keeps the backward's intermediates alive until it ends: the
        gemma3-1b round of ``chip_smoke.py`` peaks at 72 GiB on an H100
        that way, at 45 GiB this way.)"""
        with torch.enable_grad():
            tracked = tree_map(lambda x: x.detach().requires_grad_(),
                               params)
            losses, _ = worker_losses(tracked, mb)
            flat = iter(torch.autograd.grad(
                losses.sum(), tree_leaves(tracked), allow_unused=True))

        def grad_of(x, d):
            # a shared leaf's gradient is all-reduced (under a mesh) and
            # divided in place: the tuple of gradients stays alive until
            # the last leaf, and a new tensor per shared leaf would hold a
            # second copy of them all (24 GiB for olmoe-1b-7b's experts)
            g = next(flat)
            g = torch.zeros_like(x) if g is None else g
            if d == 0:
                return g
            if mesh is not None:
                g = smagg.all_reduce_(g.contiguous(), mesh)
            return g.div_(n_workers)

        return tree_map(grad_of, tracked, in_dims), losses.detach()

    def per_worker_losses(params, mb):
        """The workers' losses (p,) on a microbatch with leading dims
        (p, b_local), forward only."""
        with torch.no_grad():
            return worker_losses(params, mb)[0]

    def reshape_batch(batch):
        def r(x):
            b = x.shape[0]
            if b % (tau * n_local):
                raise ValueError(f"batch {b} not divisible by tau*p = "
                                 f"{tau}*{n_local}")
            x = x.reshape(n_local, tau, b // (tau * n_local),
                          *x.shape[1:])
            return x.transpose(0, 1)            # (tau, p, b_local, ...)
        return tree_map(r, batch)

    def worker_l2(tree_a, tree_b=None):
        """Per-worker L2 norm over the worker-stacked leaves: (p,), this
        shard's rows under a mesh."""
        leaves_ax = tree_leaves(axes)
        la = tree_leaves(tree_a)
        lb = tree_leaves(tree_b) if tree_b is not None else la
        total = torch.zeros(n_local, dtype=torch.float32,
                            device=la[0].device)
        for xa, xb, ax in zip(la, lb, leaves_ax):
            if not agg.is_worker_leaf(ax):
                continue
            d = xa.float()
            if tree_b is not None:
                d = d - xb.float()
            total = total + torch.square(d).reshape(n_local, -1).sum(dim=1)
        return torch.sqrt(total)

    def run_scan(state, mb, collect_gnorm=False):
        """tau local steps; returns (params, opt_state, energy) and
        ``(round_losses, step_losses, gnorm0)``: the (tau,) per-step mean
        losses over every worker, the (tau, p) per-worker losses, and
        with ``collect_gnorm`` the workers' gradient norms (p,) at t = 0
        (else None); the energies, the per-worker losses and the norms
        are this shard's rows under a mesh. The optimizer's leaf-wise
        ``apply``
        replaces each leaf of the ``state.params`` (and optimizer state)
        dicts by its new tensor and drops its gradient before the next
        leaf (no tensor is written in place): the round consumes its input
        state, as the JAX Trainer donates it to the jitted step
        (``donate_argnums=(0,)``), and a step holds the parameters, their
        gradients and one new leaf, not a third copy of the worker-stacked
        parameters."""
        params, opt_state, energy = (state.params, state.opt_state,
                                     state.energy)
        step_means, step_losses, gnorm0 = [], [], None
        with span("round.local_steps"):
            for t in range(tau):
                grads, losses = worker_grads(params,
                                             tree_map(lambda x: x[t], mb))
                if collect_gnorm and t == 0:
                    gnorm0 = worker_l2(grads)
                opt_state = optimizer.apply(grads, opt_state, params)
                del grads
                if mask[t]:
                    energy = energy + losses
                if mesh is None:
                    step_means.append(losses.mean())
                step_losses.append(losses)
            step_losses = torch.stack(step_losses)
            if mesh is not None:            # every worker's, per step
                step_means = [row.mean() for row in
                              gather(step_losses.t().contiguous()).t()]
            step_means = torch.stack(step_means)
        return (params, opt_state, energy), (step_means, step_losses,
                                             gnorm0)

    def assemble(state, params, opt_state, comm_state, round_losses, energy,
                 theta, rule_metrics, extra=None):
        """The next state and the round's metrics; ``energy`` and
        ``extra`` are every worker's."""
        new_state = TrainState(
            step=state.step + 1,
            params=params,
            opt_state=opt_state,
            energy=torch.zeros_like(state.energy),
            comm_state=comm_state,
        )
        metrics = {
            "loss": round_losses.mean(),
            "loss_last": round_losses[-1],
            "h": energy,
            "theta": theta,
            "scores": judge_scores(energy),
            "theta_entropy": theta_entropy(theta),
            "omega": omega(theta),
            **rule_metrics,
            **(extra or {}),
        }
        return new_state, metrics

    return types.SimpleNamespace(
        mask=mask, n_local=n_local, gather=gather,
        per_worker_losses=per_worker_losses,
        reshape_batch=reshape_batch, worker_grads=worker_grads,
        worker_l2=worker_l2, run_scan=run_scan, assemble=assemble)


def build_train_step(loss_fn: LossFn, optimizer: Optimizer, axes: Dict,
                     wcfg, n_workers: int,
                     rule: Optional[Callable] = None,
                     overlap: Optional[Callable] = None,
                     pipeline: Optional[str] = None,
                     mesh=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` for one round.
    ``wcfg.async_mode="on_device"`` takes the Alg. 4 rule
    (``async_wasgd_rule``; the round's mask rides in ``state.comm_state``).
    ``overlap`` (a nullary thunk) is handed to the default rule, which
    runs it inside the aggregate; its result is ``metrics["overlap"]``
    and the params are the same either way. ``mesh`` reaches the default
    rule's backend context, and the round runs this shard's rows (the
    module docstring); a supplied ``rule`` must take every worker's
    energies and this shard's params.

    Pipelined rounds (``pipeline="parity" | "speculative"``): the builder
    returns

        ``train_step(state, batch, next_first, carry)
            -> (state, metrics, carry)``

    ``next_first`` being round ``r+1``'s first worker-major microbatch
    (leading dims ``(p, b_local)``, staged by
    ``data/pipeline.RoundPrefetcher``) and ``carry`` what one round hands
    the next (``train_step.primer(params, batch)`` makes round 0's). The
    round's seam thunk, handed to the rule's per-call ``overlap=``, runs
    inside the aggregate and stages the next round's work:

    * the staged ``next_first`` rides the seam, and round ``r+1`` copies
      it into the ``t = 0`` slice of its reshaped batch, in place, so its
      first step reads the same buffer as the unpipelined round (equal
      values by the prefetcher's correctness);
    * ``"speculative"`` also runs the Judge's forward for that microbatch
      on the pre-aggregate params.

    ``"parity"`` gives params and metrics bitwise equal to the unpipelined
    round's. ``"speculative"`` puts the seam forward's stale losses in
    place of round ``r+1``'s ``t = 0`` energy term (the Judge is a
    heuristic; paper Sec. 3.4): they are one Eq. 10 step stale, since the
    seam evaluates at ``x_i`` where the round evaluates at
    ``x_i' = x_i + beta (m - x_i)`` (a straggler: ``x_i' = m``), so

        ``|L_i(x_i) - L_i(x_i')| <= sup_seg ||grad L_i|| * ||x_i' - x_i||``.

    The round measures both sides: ``metrics["spec_dev"]`` is
    ``|spec - true|`` per worker, ``metrics["spec_bound"]`` the endpoint
    surrogate ``||grad L_i(x_i')|| * ||x_i' - x_i||`` (round ``r+1``'s
    t = 0 gradient norm times round ``r``'s step); at ``beta = 0`` the
    deviation is exactly 0. The params never take the seam's losses.
    """
    if pipeline is not None:
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"unknown pipeline mode {pipeline!r}; "
                             f"known: {PIPELINE_MODES}")
        if overlap is not None:
            raise ValueError(
                "pipeline= and overlap= both claim the aggregation "
                "schedule's phase-gap seam; pass one or the other")
        if rule is not None \
                and "overlap" not in inspect.signature(rule).parameters:
            raise ValueError(
                "pipelined rounds thread the seam thunk through the "
                "rule's per-call overlap= keyword; the supplied rule "
                "does not accept one (use wasgd_rule/async_wasgd_rule, "
                "or add an overlap= kwarg)")
    if rule is None:
        rule = (async_wasgd_rule(wcfg, mesh=mesh, overlap=overlap)
                if wcfg.async_mode == "on_device"
                else wasgd_rule(wcfg, mesh=mesh, overlap=overlap))
    parts = _round_parts(loss_fn, optimizer, axes, wcfg, n_workers, mesh)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        mb = parts.reshape_batch(batch)
        (params, opt_state, energy), (round_losses, _, _) = parts.run_scan(
            state, mb)
        with span("round.aggregate"):
            h = parts.gather(energy)
            params, comm_state, theta, rule_metrics = rule(
                params, axes, h, state.comm_state)
            return parts.assemble(state, params, opt_state, comm_state,
                                  round_losses, h, theta, rule_metrics)

    if pipeline is None:
        return train_step
    speculative = pipeline == "speculative"

    def pipelined_step(state: TrainState, batch: Dict, next_first: Dict,
                       carry: Dict):
        mb = parts.reshape_batch(batch)
        # round r-1's seam output is this round's t = 0 microbatch
        tree_map(lambda m, f: m[0].copy_(f), mb, carry["first"])
        (params, opt_state, energy), (round_losses, losses_tw, gnorm0) = \
            parts.run_scan(state, mb, collect_gnorm=speculative)
        extra = {}
        if speculative:
            # the seam's stale losses (on round r-1's pre-aggregate
            # params) take the t = 0 energy term; the gradients do not
            true0, spec = losses_tw[0], carry["spec_losses"]
            if parts.mask[0]:
                energy = energy + (spec - true0)
            extra = {"spec_losses": parts.gather(spec),
                     "spec_dev": parts.gather(torch.abs(spec - true0)),
                     "spec_bound": parts.gather(gnorm0 * carry["comm_delta"])}
        pre_agg = params
        h = parts.gather(energy)

        def seam():
            staged = {"first": next_first}
            if speculative:
                staged["spec_losses"] = parts.per_worker_losses(
                    pre_agg, next_first)
            return staged

        with span("round.aggregate"):
            params, comm_state, theta, rule_metrics = rule(
                pre_agg, axes, h, state.comm_state, overlap=seam)
            seam_out = rule_metrics.pop("overlap")
            carry_out = {"first": seam_out["first"]}
            if speculative:
                carry_out["spec_losses"] = seam_out["spec_losses"]
                carry_out["comm_delta"] = parts.worker_l2(params, pre_agg)
            del pre_agg
            new_state, metrics = parts.assemble(
                state, params, opt_state, comm_state, round_losses, h,
                theta, rule_metrics, extra)
        return new_state, metrics, carry_out

    def primer(params: Dict, batch: Dict) -> Dict:
        """Round 0's carry: the round's own first microbatch (a copy) and,
        speculatively, its forward on the initial params, which are round
        0's starting params: round 0's deviation is exactly 0."""
        first = tree_map(lambda m: m[0].clone(), parts.reshape_batch(batch))
        carry = {"first": first}
        if speculative:
            carry["spec_losses"] = parts.per_worker_losses(params, first)
            carry["comm_delta"] = torch.zeros(
                parts.n_local, dtype=torch.float32,
                device=carry["spec_losses"].device)
        return carry

    pipelined_step.primer = primer
    pipelined_step.pipeline = pipeline
    return pipelined_step


def build_phased_train_step(loss_fn: LossFn, optimizer: Optimizer,
                            axes: Dict, wcfg, n_workers: int, mesh=None,
                            overlap: Optional[Callable] = None) -> Callable:
    """The round of ``build_train_step`` with the default wasgd/Alg. 4
    rule, run phase by phase so that the Trainer can time each:

        local_steps  the tau local steps (gradients, update, energies)
        judge        the policy: energies -> theta (under a mesh, with
                     the energies' all-gather)
        reduce       the schedule's reduce phase with every leaf's prepare
                     (``reduce_scatter`` / ``all_gather`` for the
                     two-phase ``hierarchical``)
        overlap      the ``overlap=`` thunk, if any
        finalize     every leaf's Eq. 10 FMA and the state assembly

    Returns ``phased_step(state, batch) -> (state, metrics, phases)``,
    ``phases`` mapping names to seconds. Each phase ends in
    ``torch.cuda.synchronize`` on a card (nothing on the CPU) before its
    timer stops. The arithmetic is the fused round's, op for op, so the
    params are bitwise its. It runs only for a real telemetry sink
    (``Trainer.run(telemetry=)``): it fences every phase, and it holds
    every leaf's reduce state at once (``core.backends.PhaseMajor``).
    ``"auto"`` resolves per tree at the round."""
    parts = _round_parts(loss_fn, optimizer, axes, wcfg, n_workers, mesh)
    pol = policy_from_config(wcfg)
    async_mode = wcfg.async_mode == "on_device"
    name = backends.backend_name_from_config(wcfg)
    if name != "auto":
        if async_mode:
            name = async_device.async_backend_name(name)
        _needs_mesh_check(name, mesh, "build_phased_train_step")
        _check_pods(wcfg, name)
    ctx_base = backends.context_from_config(wcfg, mesh)

    def backend_for(params):
        nm = name
        if nm == "auto":
            nm = backends.select_auto_spec(params, axes, mesh,
                                           n_pods=wcfg.n_pods,
                                           require_mask=async_mode)
            if async_mode:
                nm = async_device.async_backend_name(nm)
        return backends.get_backend(nm)

    def judge(energy, active, pstate, **kw):
        h = parts.gather(energy)
        return h, pol(h, active, pstate, **kw)

    def phased_step(state: TrainState, batch: Dict):
        device = tree_leaves(state.params)[0].device
        phases: Dict[str, float] = {}

        def timed(nm, thunk):
            t0 = time.perf_counter()
            out = thunk()
            fence(device)
            phases[nm] = phases.get(nm, 0.0) + (time.perf_counter() - t0)
            return out

        def local_steps():
            mb = parts.reshape_batch(batch)
            return parts.run_scan(state, mb)

        (params, opt_state, energy), (round_losses, _, _) = timed(
            "local_steps", local_steps)
        cs = state.comm_state
        if async_mode:
            active, pstate = ((cs["active"], cs["policy"]) if pol.stateful
                              else (cs, ()))
            energy, (theta, pstate) = timed("judge", lambda: judge(
                energy, active, pstate, checked=True))
            act = active.float()
            ctx = dataclasses.replace(ctx_base, active=act)
            rule_metrics = {"active": act}
            comm_state = ({"active": active, "policy": pstate}
                          if pol.stateful else cs)
        else:
            energy, (theta, comm_state) = timed("judge", lambda: judge(
                energy, None, cs))
            ctx, rule_metrics = ctx_base, {}
        backend = backend_for(params)
        reduce_names = (("reduce_scatter", "all_gather")
                        if backend.schedule.n_phases == 2 else ("reduce",))
        run = backend.phase_major(params, axes, theta, ctx=ctx)
        timed(reduce_names[0], lambda: run.reduce(0))
        overlap_out = None
        if overlap is not None:
            overlap_out = timed("overlap", overlap)
        for k, nm in enumerate(reduce_names[1:], start=1):
            timed(nm, lambda k=k: run.reduce(k))

        def finalize():
            return parts.assemble(state, run.finalize(wcfg.beta), opt_state,
                                  comm_state, round_losses, energy, theta,
                                  rule_metrics)

        new_state, metrics = timed("finalize", finalize)
        if overlap is not None:
            metrics = {**metrics, "overlap": overlap_out}
        return new_state, metrics, phases

    return phased_step


def init_comm_state(rule_name: str, params: Dict, axes: Dict,
                    n_workers: int, wcfg=None, prev=None):
    """A rule's communication state, on the params' device: EASGD's
    center, the MWU log-weights, the wasgd/wasgd+ policy state (``()`` for
    a stateless policy; under ``async_mode="on_device"`` an all-active
    mask, beside the policy state if it is stateful), ``()`` for the
    others. ``prev=``: the previous round's state, re-sharded to
    ``n_workers`` across a membership resize
    (``core/membership.resize_comm_state``); the baseline rules have no
    such re-shard."""
    if prev is not None:
        from repro_torch.core.membership import resize_comm_state
        if rule_name not in ("wasgd", "wasgd+"):
            raise ValueError(
                f"rule {rule_name!r} has no elastic comm-state re-shard")
        pol = (policy_from_config(wcfg)
               if wcfg is not None and policy_from_config(wcfg).stateful
               else None)
        return resize_comm_state(prev, n_workers, policy=pol)
    dev = tree_leaves(params)[0].device
    if rule_name == "easgd":
        return bl.easgd_init(params, axes)
    if rule_name in ("omwu", "mmwu", "mwu"):
        return bl.mwu_init(n_workers, dev)
    if wcfg is None or rule_name not in ("wasgd", "wasgd+"):
        return ()
    pol = policy_from_config(wcfg)
    pstate = pol.init_state(n_workers, dev)
    if wcfg.async_mode == "on_device":
        mask = torch.ones(n_workers, dtype=torch.bool, device=dev)
        return {"active": mask, "policy": pstate} if pol.stateful else mask
    return pstate
