"""Host-side training loop, the counterpart of
``repro/train/trainer.py::Trainer``: synchronous WASGD/WASGD+ rounds and
the paper's baseline rules, the run's metrics, checkpoints and the
train-to-serve hook.

The device side of a round is ``train/step.py``; the Trainer moves each
round's batch to the device, runs the step, reads the round's metrics
back into ``history`` (and, given ``metrics_path``, one JSON line a
round), feeds the Judge scores into the order search
(``core/order.OrderState``), whose keep-or-reshuffle decisions shape the
batches of later rounds, hands the live params to ``serve_hook`` and
saves sharded checkpoints of the full train state in the background.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
queue item: pipelined rounds, elastic membership (and with it a resume
at another worker count), straggler schedules and telemetry.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (AsyncCheckpointer, _flatten, restore,
                                       saved_topology)
from repro_torch.core import replicate_workers
from repro_torch.core.order import OrderState
from repro_torch.data.pipeline import OrderedDataset
from repro_torch.device import resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.train import step as step_mod
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import build_train_step, init_comm_state
from repro_torch.tree import tree_map

_NOT_PORTED = {
    "pipeline": "pipelined rounds (ROADMAP.md queue 1.8)",
    "straggler_schedule": "straggler schedules (ROADMAP.md queue 1.1)",
    "membership_schedule": "elastic membership (ROADMAP.md queue 1.3)",
    "telemetry": "telemetry (ROADMAP.md queue 1.10)",
}

RULES = {
    "wasgd": lambda tcfg: step_mod.wasgd_rule(tcfg.wasgd),
    "wasgd+": lambda tcfg: step_mod.wasgd_rule(tcfg.wasgd),
    "spsgd": lambda tcfg: step_mod.spsgd_rule(),
    "easgd": lambda tcfg: step_mod.easgd_rule(alpha=0.9 / 16),
    "omwu": lambda tcfg: step_mod.mwu_rule(),
    "mmwu": lambda tcfg: step_mod.mwu_rule(),
    "seq": lambda tcfg: step_mod.no_comm_rule(),
}


def _refuse(**given) -> None:
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(f"Trainer {name}=: "
                                      f"{_NOT_PORTED[name]} is not ported "
                                      f"yet")


class Trainer:
    def __init__(self, loss_fn, params: Dict, axes: Dict, tcfg, n_workers: int,
                 rule: str = "wasgd", device=None,
                 easgd_alpha: Optional[float] = None,
                 pipeline: Optional[str] = None):
        """``params``: a single-copy tree, moved to ``device`` (``None``:
        cuda; raises without a card unless ``"cpu"``) and replicated to
        ``n_workers`` worker copies. ``rule``: a key of ``RULES``;
        ``easgd_alpha`` overrides the ``easgd`` rule's moving rate."""
        _refuse(pipeline=pipeline)
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.n_workers = n_workers
        self.rule_name = rule
        if rule == "easgd" and easgd_alpha is not None:
            rule_fn = step_mod.easgd_rule(easgd_alpha)
        else:
            rule_fn = RULES[rule](tcfg)
        params, axes = replicate_workers(
            tree_map(lambda x: x.to(self.device), params), axes, n_workers)
        self.axes = axes
        comm_state = init_comm_state(rule, params, axes, n_workers,
                                     wcfg=tcfg.wasgd)
        self.optimizer = make_optimizer(
            tcfg.optimizer, tcfg.learning_rate, tcfg.momentum,
            tcfg.weight_decay)
        self.state: TrainState = init_state(
            params, self.optimizer.init(params), n_workers, comm_state)
        self._step = build_train_step(loss_fn, self.optimizer, axes,
                                      tcfg.wasgd, n_workers, rule=rule_fn)
        self._ckpt: Optional[AsyncCheckpointer] = None     # made at first save
        self.history: list = []

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

    def save_checkpoint(self, path: str, round: int) -> None:
        """Sharded save of the full train state (params, optimizer state,
        energies, comm state). Returns once the state is copied on its
        device; a background thread copies it to the host and writes it
        (``checkpoint.AsyncCheckpointer``)."""
        if self._ckpt is None:
            self._ckpt = AsyncCheckpointer()
        self._ckpt.save(path, self.state, meta={"round": int(round)},
                        topology=self._topology(round))

    def resume(self, path: str, allow_cast: bool = False) -> int:
        """Restores a checkpoint (the JAX Trainer's or this one's, flat or
        sharded) into this trainer and returns the round to resume at. A
        checkpoint saved at another worker count raises: resizing needs
        elastic membership, which is not ported."""
        topo = saved_topology(path)["topology"]
        saved_p = int(topo.get("p", self.n_workers))
        if topo.get("rule") is not None and topo["rule"] != self.rule_name:
            raise ValueError(
                f"checkpoint was saved by rule {topo['rule']!r}; this "
                f"trainer runs {self.rule_name!r}")
        if saved_p != self.n_workers:
            if self.rule_name not in ("wasgd", "wasgd+"):
                raise ValueError(
                    f"checkpoint p={saved_p} != trainer p={self.n_workers} "
                    f"and rule {self.rule_name!r} has no elastic resize")
            raise NotImplementedError(
                f"checkpoint p={saved_p} != trainer p={self.n_workers}: "
                f"resuming at another worker count needs "
                f"{_NOT_PORTED['membership_schedule']}, which is not "
                f"ported yet")
        self.state, meta = restore(path, self.state, allow_cast=allow_cast)
        return int(topo.get("round", meta.get("round", 0)))

    # -- the loop -----------------------------------------------------------

    def run(self, batches: Iterator[Dict], n_rounds: int,
            order_state: Optional[OrderState] = None,
            segment_fn: Optional[Callable[[int], int]] = None,
            log_every: int = 0, metrics_path: Optional[str] = None,
            checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None,
            straggler_schedule=None, membership_schedule=None,
            resume_from: Optional[str] = None,
            serve_hook: Optional[Callable[[int, Dict, Dict], Any]] = None,
            serve_every: int = 1, telemetry=None) -> Dict:
        """``batches`` is a round-batch iterator of numpy dicts, or an
        ``OrderedDataset`` (its ``order``/``segment_of_round`` then feed
        the order search unless given). Each round's metrics land in
        ``history`` as numpy arrays, and its Judge scores are recorded in
        ``order_state`` for the round's segment.

        ``metrics_path``: one JSON line a round is appended (the metrics
        as lists, and ``round``). ``log_every``: a progress line every so
        many rounds. ``serve_hook(round, params, axes)`` is called after
        the step every ``serve_every`` rounds with the live worker-stacked
        params (``serve.HotSwapBridge`` swaps their consensus into a
        running engine). ``checkpoint_every``/``checkpoint_path`` save the
        full train state every so many rounds
        (``checkpoint_path/round_{r+1}``, sharded, in the background; the
        run waits for the writes before it returns). ``resume_from``
        restores such a checkpoint and continues at its round; an
        ``OrderedDataset`` then restarts its batches at that round."""
        _refuse(straggler_schedule=straggler_schedule,
                membership_schedule=membership_schedule,
                telemetry=telemetry)
        ds = None
        if isinstance(batches, OrderedDataset):
            ds = batches
            if order_state is None and segment_fn is None:
                order_state, segment_fn = ds.order, ds.segment_of_round
        start = 0
        if resume_from is not None:
            start = self.resume(resume_from)
            if start >= n_rounds:
                raise ValueError(
                    f"checkpoint {resume_from} is at round {start}, at or "
                    f"past n_rounds={n_rounds} - nothing left to run")
        if ds is not None:
            batches = ds.batches(start_round=start)
        t0 = time.time()
        mf = open(metrics_path, "a") if metrics_path else None
        try:
            for r in range(start, n_rounds):
                batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in next(batches).items()}
                self.state, metrics = self._step(self.state, batch)
                rec = {k: v.cpu().numpy() for k, v in metrics.items()}
                rec["round"] = r
                self.history.append(rec)
                if order_state is not None:
                    seg = segment_fn(r) if segment_fn else 0
                    order_state.record_scores(seg, rec["scores"])
                if mf is not None:
                    mf.write(json.dumps(
                        {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                         for k, v in rec.items()}) + "\n")
                    mf.flush()
                if serve_hook is not None \
                        and (r + 1) % max(1, serve_every) == 0:
                    serve_hook(r, self.state.params, self.axes)
                if checkpoint_every and checkpoint_path \
                        and (r + 1) % checkpoint_every == 0:
                    self.save_checkpoint(
                        os.path.join(checkpoint_path, f"round_{r+1}"), r + 1)
                if log_every and (r + 1) % log_every == 0:
                    print(f"round {r+1}/{n_rounds} loss={rec['loss']:.4f} "
                          f"theta_entropy={rec['theta_entropy']:.3f}")
        finally:
            if mf is not None:
                mf.close()
            if self._ckpt is not None:
                self._ckpt.wait()          # a failed save raises here
        return {"rounds": n_rounds - start, "wall": time.time() - t0,
                "final_loss": float(self.history[-1]["loss"])}

    def losses(self) -> np.ndarray:
        return np.array([h["loss"] for h in self.history])
