"""Host-side training loop, the counterpart of
``repro/train/trainer.py::Trainer``: WASGD/WASGD+ rounds, synchronous or
Alg. 4 straggler rounds (``async_mode="on_device"``,
``run(straggler_schedule=)``), elastic membership (``resize``,
``run(membership_schedule=)``, a resume at another worker count), the
paper's baseline rules, the run's metrics, checkpoints and the
train-to-serve hook.

The device side of a round is ``train/step.py``; the Trainer moves each
round's batch to the device, runs the step, reads the round's metrics
back into ``history`` (and, given ``metrics_path``, one JSON line a
round), feeds the Judge scores into the order search
(``core/order.OrderState``), whose keep-or-reshuffle decisions shape the
batches of later rounds, hands the live params to ``serve_hook`` and
saves sharded checkpoints of the full train state in the background.
Pipelined rounds (``Trainer(pipeline=)``) stage the next round on a
background thread (``data/pipeline.RoundPrefetcher``) and carry its first
microbatch through the aggregate's seam; ``run(telemetry=)`` emits the
``repro_torch.obs`` records.

``Trainer(mesh=)`` trains decentralized across processes: each rank of
the ``DeviceMesh`` steps its shard's worker rows (``core/shardmap_agg``);
the energies, Judge scores and Alg. 4 times are all-gathered before the
policy, so every rank computes the same theta, policy state and order
decision, and ``history``/``losses()`` are the same on every rank. Every
rule runs there, a resize moves the rows between ranks
(``core/membership``), and each rank writes its own shards of a
checkpoint and reads its own rows back (``checkpoint/io``). A leaf
without the worker axis is one copy on every rank, updated alike on each.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (AsyncCheckpointer, Rows, _flatten,
                                       restore, saved_topology)
from repro_torch.core import replicate_workers
from repro_torch.core import shardmap_agg as smagg
from repro_torch.core.async_device import validate_active_rounds
from repro_torch.core.aggregate import is_worker_leaf
from repro_torch.core.membership import (MembershipSchedule, WorkerSet,
                                         map_opt_state, resize_train_state,
                                         resized_template)
from repro_torch.core.order import OrderState
from repro_torch.core.weights import policy_from_config
from repro_torch.data.pipeline import (OrderedDataset, RoundPrefetcher,
                                       rank_rows)
from repro_torch.device import fence, resolve_device
from repro_torch.obs import (NULL, MembershipChange, RoundTrace,
                             WorkerAssessment, span, summarize_policy_state)
from repro_torch.optim import make_optimizer
from repro_torch.train import step as step_mod
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import build_train_step, init_comm_state
from repro_torch.tree import tree_map


def _wasgd_rule_for(tcfg, mesh=None, overlap=None):
    """The synchronous Eq. 10 rule, or the Alg. 4 masked rule when the
    config selects ``async_mode="on_device"`` (the mask rides in
    ``state.comm_state``); ``overlap`` is the thunk the aggregate runs
    between its phases (``train/step.py``)."""
    if tcfg.wasgd.async_mode == "on_device":
        return step_mod.async_wasgd_rule(tcfg.wasgd, mesh=mesh,
                                         overlap=overlap)
    return step_mod.wasgd_rule(tcfg.wasgd, mesh=mesh, overlap=overlap)


def _to_host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


RULES = {
    "wasgd": _wasgd_rule_for,
    "wasgd+": _wasgd_rule_for,
    "spsgd": lambda tcfg, mesh=None, overlap=None:
        step_mod.spsgd_rule(mesh=mesh),
    "easgd": lambda tcfg, mesh=None, overlap=None:
        step_mod.easgd_rule(alpha=0.9 / 16, mesh=mesh),
    "omwu": lambda tcfg, mesh=None, overlap=None:
        step_mod.mwu_rule(mesh=mesh),
    "mmwu": lambda tcfg, mesh=None, overlap=None:
        step_mod.mwu_rule(mesh=mesh),
    "seq": lambda tcfg, mesh=None, overlap=None: step_mod.no_comm_rule(),
}


class Trainer:
    def __init__(self, loss_fn, params: Dict, axes: Dict, tcfg, n_workers: int,
                 rule: str = "wasgd", device=None,
                 easgd_alpha: Optional[float] = None, mesh=None,
                 overlap=None, pipeline: Optional[str] = None):
        """``params``: a single-copy tree, moved to ``device`` (``None``:
        cuda; raises without a card unless ``"cpu"``) and replicated to
        ``n_workers`` worker copies; the leaves whose axes name
        ``"experts"`` stay one copy unless ``tcfg`` carries
        ``expert_copies=True`` (read with ``getattr``, as JAX's Trainer
        does). ``rule``: a key of ``RULES``;
        ``easgd_alpha`` overrides the ``easgd`` rule's moving rate.
        ``overlap`` (a nullary thunk, its result any tree) runs inside the
        aggregate, between its phases; its result lands in
        ``history[r]["overlap"]``.

        ``pipeline="parity" | "speculative"`` pipelines the round
        (``train/step.py``): ``run`` stages the batches through a
        ``RoundPrefetcher`` on the trainer's device, and round ``r+1``'s
        first microbatch rides round ``r``'s aggregate seam. ``"parity"``
        is bitwise the unpipelined trainer; ``"speculative"`` also runs
        the next round's Judge forward on the pre-aggregate params (one
        Eq. 10 step stale, measured each round in
        ``history[r]["spec_dev"]`` / ``["spec_bound"]``). Only the
        wasgd/wasgd+ rules carry the seam. The prefetcher's generator runs
        up to ``RoundPrefetcher.run_ahead()`` rounds ahead, so build an
        ``OrderedDataset`` with ``boundary_delay=RoundPrefetcher.
        run_ahead()`` to keep its OrderGen decisions on the recorded
        Judge scores.

        ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` whose worker axes
        are ``("data",)`` or ``("pod", "data")``, JAX's names) makes the
        run decentralized: this rank keeps its shard's rows of the
        ``n_workers`` copies (``state`` holds them), takes its rows of
        each round batch (batches hold every worker's rows: ``run`` cuts
        them with ``data.rank_rows``, also after a resize; a
        ``RoundPrefetcher`` passed in must stage this rank's rows), and
        the mesh reaches the rules (every rule runs there) and the
        aggregation specs (``shard_map``, ``rs_ag`` and their ``async_``
        forms need it). Every rank must make the same calls: ``resize``,
        ``save_checkpoint`` and ``resume`` are collective too. A leaf
        without the worker axis (JAX's one-copy ``ep_data`` experts) stays
        whole on every rank, and so does its optimizer state; the round
        all-reduces its gradient. A mesh axis other than the worker axes
        (``"model"``) holds replicas: each index on it runs the round of
        the worker axes alone, and only its index 0 writes checkpoints."""
        if pipeline is not None and rule not in ("wasgd", "wasgd+"):
            raise ValueError(
                f"pipeline={pipeline!r} threads the seam thunk through the "
                f"wasgd/wasgd+ rules only (got rule={rule!r})")
        self.device = resolve_device(device)
        self._mesh = mesh
        self.tcfg = tcfg
        self.workers = WorkerSet(n_workers)
        self.rule_name = rule
        self.pipeline = pipeline
        self._loss_fn = loss_fn
        self._easgd_alpha = easgd_alpha
        self._overlap = overlap
        self._telemetry = NULL                 # set by run(telemetry=)
        self._phased_cache: Dict[int, Callable] = {}
        params, axes = replicate_workers(
            tree_map(lambda x: x.to(self.device), params), axes, n_workers,
            expert_copies=getattr(tcfg, "expert_copies", False))
        self.axes = axes
        comm_state = init_comm_state(rule, params, axes, n_workers,
                                     wcfg=tcfg.wasgd)
        if mesh is not None:                 # this shard's rows
            rows = smagg.local_rows(n_workers, mesh)
            params = tree_map(lambda x, ax: x[rows].contiguous()
                              if is_worker_leaf(ax) else x, params, axes)
        self.optimizer = make_optimizer(
            tcfg.optimizer, tcfg.learning_rate, tcfg.momentum,
            tcfg.weight_decay)
        self.state: TrainState = init_state(
            params, self.optimizer.init(params),
            smagg.local_workers(n_workers, mesh), comm_state)
        self._ckpt: Optional[AsyncCheckpointer] = None     # made at first save
        self._build_step()
        self.history: list = []

    @property
    def n_workers(self) -> int:
        """The live worker count, the ``WorkerSet``'s (changed only by
        ``resize``)."""
        return self.workers.p

    def _build_step(self):
        """Builds the round for the current membership (the step closes
        over ``n_workers``); ``resize`` calls it again."""
        if self.rule_name == "easgd" and self._easgd_alpha is not None:
            rule_fn = step_mod.easgd_rule(self._easgd_alpha, mesh=self._mesh)
        else:
            rule_fn = RULES[self.rule_name](self.tcfg, mesh=self._mesh,
                                            overlap=self._overlap)
        self._step = build_train_step(self._loss_fn, self.optimizer,
                                      self.axes, self.tcfg.wasgd,
                                      self.n_workers, rule=rule_fn,
                                      pipeline=self.pipeline,
                                      mesh=self._mesh)
        self._primer = getattr(self._step, "primer", None)

    def _policy_for_resize(self):
        if self.rule_name not in ("wasgd", "wasgd+"):
            return None
        pol = policy_from_config(self.tcfg.wasgd)
        return pol if pol.stateful else None

    def resize(self, new_p: int, round: Optional[int] = None):
        """Commits a membership change at a round boundary: the train
        state is re-sharded (survivors keep their slots bitwise, newcomers
        adopt the aggregate; ``core/membership.py``), the comm state
        through ``init_comm_state(prev=)``, and the round is rebuilt for
        the new count. Returns the ``MembershipEvent``, or None when
        ``new_p`` is the live count. Under a mesh ``new_p`` must be a
        multiple of the shard count (else ``ValueError``, before any
        collective), and the rows move between the ranks."""
        if self.rule_name not in ("wasgd", "wasgd+"):
            raise ValueError(
                f"elastic membership is a wasgd/wasgd+ capability — rule "
                f"{self.rule_name!r} pins worker count at construction")
        new_p = int(new_p)
        smagg.local_workers(new_p, self._mesh)   # raises on every rank
        if new_p == self.n_workers:
            return None
        comm = init_comm_state(self.rule_name, self.state.params, self.axes,
                               new_p, wcfg=self.tcfg.wasgd,
                               prev=self.state.comm_state)
        self.state = resize_train_state(self.state, self.axes, new_p,
                                        policy=self._policy_for_resize(),
                                        comm_state=comm, mesh=self._mesh)
        old_p = self.n_workers
        event = self.workers.resize(new_p, round=round)
        self._build_step()
        if event is not None and self._telemetry.enabled:
            self._telemetry.emit(MembershipChange(
                round=round if round is not None else -1, old_p=old_p,
                new_p=new_p, generation=self.workers.generation))
        return event

    # -- sharded, resumable checkpoints -----------------------------------

    def _topology(self, round: int) -> Dict:
        """The record a sharded checkpoint carries, as the JAX Trainer
        writes it: the worker count, the round, the rule, the policy and
        the comm state's keys."""
        return {
            "p": self.n_workers,
            "round": int(round),
            "rule": self.rule_name,
            "policy": self.tcfg.wasgd.policy,
            "comm_state": sorted(_flatten({"cs": self.state.comm_state})),
        }

    def _row_keys(self):
        """The checkpoint keys whose leaves are this rank's worker rows:
        the worker leaves of the params and of the optimizer state, and
        the energies."""
        marks = tree_map(is_worker_leaf, self.axes)
        flat = _flatten(self.state._replace(
            step=False, params=marks, energy=True, comm_state=(),
            opt_state=map_opt_state(lambda _: marks, self.state.opt_state,
                                    self.axes)))
        return frozenset(k for k, v in flat.items() if v is True)

    def save_checkpoint(self, path: str, round: int) -> None:
        """Sharded save of the full train state (params, optimizer state,
        energies, comm state). Returns once the state is copied on its
        device; a background thread copies it to the host and writes it
        (``checkpoint.AsyncCheckpointer``). Under a mesh every rank calls
        it: the rows of each shard's keys are gathered to the rank that
        writes the shard first (one shard a rank), and the files are the
        meshless save's with as many shards."""
        if self._ckpt is None:
            self._ckpt = AsyncCheckpointer(telemetry=self._telemetry)
        self._ckpt.save(path, self.state, meta={"round": int(round)},
                        topology=self._topology(round), mesh=self._mesh,
                        row_keys=self._row_keys())

    def resume(self, path: str, allow_cast: bool = False) -> int:
        """Restores a checkpoint (the JAX Trainer's or this one's, flat or
        sharded) into this trainer and returns the round to resume at. A
        sharded checkpoint saved at another worker count is restored at
        its recorded ``p`` and then resized to this trainer's: the saved
        survivors land bitwise in their slots, newcomers adopt the
        aggregate. Under a mesh each rank reads its own rows (of a
        checkpoint saved under any number of ranks, or none), and a
        recorded ``p`` must be a multiple of the shard count."""
        topo = saved_topology(path)["topology"]
        saved_p = int(topo.get("p", self.n_workers))
        if topo.get("rule") is not None and topo["rule"] != self.rule_name:
            raise ValueError(
                f"checkpoint was saved by rule {topo['rule']!r}; this "
                f"trainer runs {self.rule_name!r}")
        pol = self._policy_for_resize()
        like = self.state
        if saved_p != self.n_workers:
            if self.rule_name not in ("wasgd", "wasgd+"):
                raise ValueError(
                    f"checkpoint p={saved_p} != trainer p={self.n_workers} "
                    f"and rule {self.rule_name!r} has no elastic resize")
            like = resized_template(self.state, self.axes, saved_p,
                                    policy=pol, mesh=self._mesh)
        rows = None
        if self._mesh is not None:
            rows = Rows(self._row_keys(), saved_p,
                        smagg.local_rows(saved_p, self._mesh))
        restored, meta = restore(path, like, allow_cast=allow_cast,
                                 rows=rows)
        if saved_p != self.n_workers:
            restored = resize_train_state(restored, self.axes,
                                          self.n_workers, policy=pol,
                                          mesh=self._mesh)
        self.state = restored
        return int(topo.get("round", meta.get("round", 0)))

    # -- telemetry ---------------------------------------------------------

    def _phased_step(self):
        """The phase-fenced round for the current worker count (kept per
        count), or None where the run cannot be split into phases:
        pipelined rounds and the baseline rules report a fenced total
        only. Built only when a real sink is attached."""
        if self.rule_name not in ("wasgd", "wasgd+") \
                or self.pipeline is not None:
            return None
        fn = self._phased_cache.get(self.n_workers)
        if fn is None:
            fn = step_mod.build_phased_train_step(
                self._loss_fn, self.optimizer, self.axes, self.tcfg.wasgd,
                self.n_workers, mesh=self._mesh, overlap=self._overlap)
            self._phased_cache[self.n_workers] = fn
        return fn

    def _emit_round(self, tele, r: int, rec: Dict, total_s: float,
                    host_staging_s: float, phase_times) -> None:
        """The round's ``RoundTrace`` and ``WorkerAssessment``, from the
        metrics already read back."""
        tele.emit(RoundTrace(
            round=r, total_s=total_s, host_staging_s=host_staging_s,
            phases=dict(phase_times) if phase_times is not None else {},
            detail="phased" if phase_times is not None else "fused",
            p=self.n_workers))
        theta, h, active = rec.get("theta"), rec.get("h"), rec.get("active")
        pstate = None
        if self.rule_name in ("wasgd", "wasgd+"):
            cs = self.state.comm_state
            if isinstance(cs, dict):
                pstate = cs.get("policy")
            elif self.tcfg.wasgd.async_mode != "on_device":
                pstate = cs
        tele.emit(WorkerAssessment(
            round=r,
            theta=(np.ravel(theta).astype(float).tolist()
                   if theta is not None else []),
            energies=(np.ravel(h).astype(float).tolist()
                      if h is not None else []),
            theta_entropy=float(rec.get("theta_entropy", 0.0)),
            active=([bool(x) for x in np.ravel(active)]
                    if active is not None else None),
            policy=self.tcfg.wasgd.policy or self.tcfg.wasgd.strategy,
            policy_state=summarize_policy_state(pstate)))

    # -- the loop -----------------------------------------------------------

    def run(self, batches: Iterator[Dict], n_rounds: int,
            order_state: Optional[OrderState] = None,
            segment_fn: Optional[Callable[[int], int]] = None,
            log_every: int = 0, metrics_path: Optional[str] = None,
            checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None,
            straggler_schedule=None,
            membership_schedule: Optional[MembershipSchedule] = None,
            resume_from: Optional[str] = None,
            serve_hook: Optional[Callable[[int, Dict, Dict], Any]] = None,
            serve_every: int = 1, telemetry=None) -> Dict:
        """``batches`` is a round-batch iterator of numpy dicts, or an
        ``OrderedDataset`` (its ``order``/``segment_of_round`` then feed
        the order search unless given, and a pipelined run checks that its
        ``boundary_delay`` covers the prefetcher's run-ahead). Each
        round's metrics land in ``history`` as numpy arrays, and its Judge
        scores are recorded in ``order_state`` for the round's segment.

        ``metrics_path``: one JSON line a round is appended (the metrics
        as lists, and ``round``). ``log_every``: a progress line every so
        many rounds. ``serve_hook(round, params, axes)`` is called after
        the step every ``serve_every`` rounds with the live worker-stacked
        params (``serve.HotSwapBridge`` swaps their consensus into a
        running engine). ``checkpoint_every``/``checkpoint_path`` save the
        full train state every so many rounds
        (``checkpoint_path/round_{r+1}``, sharded, in the background; the
        run waits for the writes before it returns). ``resume_from``
        restores such a checkpoint and continues at its round (resized if
        it was saved at another worker count); an ``OrderedDataset`` then
        restarts its batches at that round.

        ``straggler_schedule`` (``async_mode="on_device"``, wasgd/wasgd+
        rules): a ``StragglerSchedule`` or ``(rounds, w)`` bool array
        covering ``n_rounds``. It is checked on the host before the run
        (every round needs an active worker), copied to the device once,
        and round ``r``'s row becomes the mask in ``state.comm_state``;
        ``history[r]["active"]`` records it.

        ``membership_schedule`` makes the run elastic: where
        ``p_of(r)`` differs from the live count, the trainer resizes
        (``resize``), the ``OrderedDataset`` re-shards its rows and its
        batches (and the prefetcher of a pipelined run) restart at round
        ``r``; ``history[r]["p"]`` records the count. It needs
        ``batches`` to be the ``OrderedDataset`` and excludes
        ``straggler_schedule`` (a fixed ``(rounds, p)`` table).

        ``telemetry``: a ``repro_torch.obs`` sink (``RingSink``,
        ``JsonlSink``; default ``NullSink``, off). With a real sink each
        round emits a ``RoundTrace`` (unpipelined wasgd/wasgd+ rounds run
        the phase-fenced round: a time for each phase; pipelined rounds
        and the baseline rules a fenced total, ``detail="fused"``) and a
        ``WorkerAssessment``; a resize emits ``MembershipChange`` and the
        checkpoint writer ``CheckpointSave``. With the default sink no
        site fences, reads or times anything, and the rounds are the
        uninstrumented ones.

        Under a mesh ``serve_hook`` receives this rank's rows of the
        params, and every count of ``membership_schedule`` must be a
        multiple of the shard count (checked before the first round)."""
        ds = None
        if isinstance(batches, OrderedDataset):
            ds = batches
            if self.pipeline is not None \
                    and ds.boundary_delay < RoundPrefetcher.run_ahead():
                raise ValueError(
                    f"pipelined run: the prefetcher's generator runs up to "
                    f"{RoundPrefetcher.run_ahead()} rounds ahead of score "
                    f"recording, but this OrderedDataset commits OrderGen "
                    f"decisions after boundary_delay={ds.boundary_delay} "
                    f"rounds — its keep-or-reshuffle would read truncated "
                    f"Judge scores; build it with boundary_delay="
                    f"RoundPrefetcher.run_ahead()")
            if order_state is None and segment_fn is None:
                order_state, segment_fn = ds.order, ds.segment_of_round
        elif self.pipeline is not None and order_state is not None:
            warnings.warn(
                "pipelined run over a bare iterator with an order_state: "
                "the Trainer cannot verify the generator defers its "
                "OrderGen decisions past the prefetch run-ahead "
                f"({RoundPrefetcher.run_ahead()} rounds); pass the "
                "OrderedDataset itself (run(ds, ...)) or build it with "
                "boundary_delay=RoundPrefetcher.run_ahead() to avoid "
                "decisions that miss the final rounds' Judge scores",
                stacklevel=2)
        masks = None
        if straggler_schedule is not None:
            if self.tcfg.wasgd.async_mode != "on_device":
                raise ValueError(
                    "straggler_schedule requires "
                    "WASGDConfig(async_mode='on_device')")
            if self.rule_name not in ("wasgd", "wasgd+"):
                raise ValueError(
                    f"straggler_schedule is only consumed by the wasgd/"
                    f"wasgd+ rules (got rule={self.rule_name!r})")
            active_rounds = np.asarray(
                getattr(straggler_schedule, "active", straggler_schedule),
                bool)
            if len(active_rounds) < n_rounds:
                raise ValueError(
                    f"straggler_schedule covers {len(active_rounds)} rounds "
                    f"but run() was asked for {n_rounds}; build the "
                    f"schedule with rounds={n_rounds} (silent reuse would "
                    f"correlate the exclusion statistics)")
            validate_active_rounds(active_rounds, rounds=n_rounds)
            masks = torch.as_tensor(active_rounds[:n_rounds],
                                    device=self.device)
        if membership_schedule is not None:
            if self.rule_name not in ("wasgd", "wasgd+"):
                raise ValueError(
                    f"membership_schedule is a wasgd/wasgd+ capability "
                    f"(got rule={self.rule_name!r})")
            if straggler_schedule is not None:
                raise ValueError(
                    "membership_schedule and straggler_schedule are "
                    "mutually exclusive: the straggler mask table is a "
                    "fixed (rounds, p) — model leaving workers as "
                    "membership events instead")
            if ds is None:
                raise ValueError(
                    "membership_schedule requires run(OrderedDataset, ...) "
                    "— a bare batch iterator bakes in a fixed worker "
                    "count, so its rounds cannot be re-sharded at a "
                    "membership event")
            for r in range(n_rounds):
                smagg.local_workers(membership_schedule.p_of(r), self._mesh)
        start = 0
        if resume_from is not None:
            start = self.resume(resume_from)
            if start >= n_rounds:
                raise ValueError(
                    f"checkpoint {resume_from} is at round {start}, at or "
                    f"past n_rounds={n_rounds} - nothing left to run")
            if ds is not None and ds.p != self.n_workers:
                ds.resize(self.n_workers)
        tele = telemetry if telemetry is not None else NULL
        self._telemetry = tele
        obs_on = bool(getattr(tele, "enabled", False))
        if self._ckpt is not None:
            self._ckpt.telemetry = tele
        if ds is not None:
            batches = ds.batches(start_round=start)
        if not isinstance(batches, RoundPrefetcher):
            batches = self._rank_batches(batches)
        t0 = time.time()
        mf = open(metrics_path, "a") if metrics_path else None
        prefetch = None
        if self.pipeline is not None and not isinstance(batches,
                                                        RoundPrefetcher):
            prefetch = RoundPrefetcher(
                batches, smagg.local_workers(self.n_workers, self._mesh),
                self.tcfg.wasgd.tau, device=self.device)
            batches = prefetch
        carry = None
        try:
            for r in range(start, n_rounds):
                with span("round.stage"):
                    if membership_schedule is not None:
                        target = membership_schedule.p_of(r)
                        if target != self.n_workers:
                            self.resize(target, round=r)
                            ds.resize(target)
                            gen = self._rank_batches(
                                ds.batches(start_round=r))
                            if prefetch is not None:
                                prefetch.resize(smagg.local_workers(
                                    target, self._mesh), gen)
                            else:
                                batches = gen
                            carry = None      # re-prime the pipelined seam
                    t_host = time.perf_counter() if obs_on else 0.0
                    if self.pipeline is not None:
                        batch, next_first = next(batches)
                    else:
                        batch = next(batches)
                        batch = {k: torch.as_tensor(v).to(self.device)
                                 for k, v in batch.items()}
                    if masks is not None:
                        cs = self.state.comm_state
                        cs = ({**cs, "active": masks[r]}
                              if isinstance(cs, dict) else masks[r])
                        self.state = self.state._replace(comm_state=cs)
                    host_staging_s = (time.perf_counter() - t_host
                                      if obs_on else 0.0)
                    phased = self._phased_step() if obs_on else None
                    phase_times = None
                    t_step = time.perf_counter() if obs_on else 0.0
                if self.pipeline is not None:
                    if carry is None:
                        carry = self._primer(self.state.params, batch)
                    self.state, metrics, carry = self._step(
                        self.state, batch, next_first, carry)
                elif phased is not None:
                    self.state, metrics, phase_times = phased(self.state,
                                                              batch)
                else:
                    self.state, metrics = self._step(self.state, batch)
                with span("round.readback"):
                    if obs_on:
                        if phase_times is None:  # one fence for the round
                            fence(self.device)
                        total_s = time.perf_counter() - t_step
                    rec = {k: tree_map(_to_host, v)
                           for k, v in metrics.items()}
                    rec["round"] = r
                    if membership_schedule is not None:
                        rec["p"] = self.n_workers
                    self.history.append(rec)
                    if obs_on:
                        self._emit_round(tele, r, rec, total_s,
                                         host_staging_s, phase_times)
                    if order_state is not None:
                        seg = segment_fn(r) if segment_fn else 0
                        order_state.record_scores(seg, rec["scores"])
                    if mf is not None:
                        mf.write(json.dumps(
                            {k: (v.tolist() if isinstance(v, np.ndarray)
                                 else v)
                             for k, v in rec.items()}) + "\n")
                        mf.flush()
                    if serve_hook is not None \
                            and (r + 1) % max(1, serve_every) == 0:
                        serve_hook(r, self.state.params, self.axes)
                    if checkpoint_every and checkpoint_path \
                            and (r + 1) % checkpoint_every == 0:
                        self.save_checkpoint(os.path.join(
                            checkpoint_path, f"round_{r+1}"), r + 1)
                    if log_every and (r + 1) % log_every == 0:
                        print(f"round {r+1}/{n_rounds} "
                              f"loss={rec['loss']:.4f} "
                              f"theta_entropy={rec['theta_entropy']:.3f}")
        finally:
            if mf is not None:
                mf.close()
            if prefetch is not None:
                prefetch.close()
            if self._ckpt is not None:
                self._ckpt.wait()          # a failed save raises here
        return {"rounds": n_rounds - start, "wall": time.time() - t0,
                "final_loss": float(self.history[-1]["loss"])}

    def _rank_batches(self, batches):
        """This rank's rows of each round batch under a mesh (the one
        place they are cut), the batches themselves without one."""
        if self._mesh is None:
            return batches
        p = self.n_workers
        return (rank_rows(b, p, self._mesh) for b in batches)

    def losses(self) -> np.ndarray:
        return np.array([h["loss"] for h in self.history])
