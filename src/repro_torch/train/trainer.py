"""Host-side training loop, the counterpart of
``repro/train/trainer.py::Trainer`` for synchronous WASGD/WASGD+ rounds.

The device side of a round is ``train/step.py``; the Trainer moves each
round's batch to the device, runs the step, reads the round's metrics
back into ``history`` and feeds the Judge scores into the order search
(``core/order.OrderState``), whose keep-or-reshuffle decisions shape the
batches of later rounds.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
queue: pipelined rounds, elastic membership, straggler schedules,
checkpoints, telemetry, the serve hook and the baseline rules.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import replicate_workers
from repro_torch.core.order import OrderState
from repro_torch.data.pipeline import OrderedDataset
from repro_torch.device import resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import build_train_step, init_comm_state
from repro_torch.tree import tree_map

_NOT_PORTED = {
    "pipeline": "pipelined rounds (ROADMAP.md queue 1.10)",
    "straggler_schedule": "straggler schedules (ROADMAP.md queue 1.9)",
    "membership_schedule": "elastic membership (ROADMAP.md queue 1.9)",
    "checkpoint_path": "checkpoints (ROADMAP.md queue 1.8)",
    "resume_from": "checkpoints (ROADMAP.md queue 1.8)",
    "telemetry": "telemetry (ROADMAP.md queue 1.11)",
    "serve_hook": "the train-to-serve hook (ROADMAP.md queue 1.6)",
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
                 pipeline: Optional[str] = None):
        """``params``: a single-copy tree, moved to ``device`` (``None``:
        cuda; raises without a card unless ``"cpu"``) and replicated to
        ``n_workers`` worker copies. ``rule``: ``"wasgd"`` or
        ``"wasgd+"``."""
        _refuse(pipeline=pipeline)
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.n_workers = n_workers
        self.rule_name = rule
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
                                      tcfg.wasgd, n_workers)
        self.history: list = []

    def run(self, batches: Iterator[Dict], n_rounds: int,
            order_state: Optional[OrderState] = None,
            segment_fn: Optional[Callable[[int], int]] = None,
            straggler_schedule=None,
            membership_schedule=None, checkpoint_path=None,
            resume_from=None, telemetry=None, serve_hook=None) -> Dict:
        """``batches`` is a round-batch iterator of numpy dicts, or an
        ``OrderedDataset`` (its ``order``/``segment_of_round`` then feed
        the order search unless given). Each round's metrics land in
        ``history`` as numpy arrays, and its Judge scores are recorded in
        ``order_state`` for the round's segment."""
        _refuse(straggler_schedule=straggler_schedule,
                membership_schedule=membership_schedule,
                checkpoint_path=checkpoint_path, resume_from=resume_from,
                telemetry=telemetry, serve_hook=serve_hook)
        if isinstance(batches, OrderedDataset):
            if order_state is None and segment_fn is None:
                order_state, segment_fn = (batches.order,
                                           batches.segment_of_round)
            batches = batches.batches()
        t0 = time.time()
        for r in range(n_rounds):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in next(batches).items()}
            self.state, metrics = self._step(self.state, batch)
            rec = {k: v.cpu().numpy() for k, v in metrics.items()}
            rec["round"] = r
            self.history.append(rec)
            if order_state is not None:
                seg = segment_fn(r) if segment_fn else 0
                order_state.record_scores(seg, rec["scores"])
        return {"rounds": n_rounds, "wall": time.time() - t0,
                "final_loss": float(self.history[-1]["loss"])}

    def losses(self) -> np.ndarray:
        return np.array([h["loss"] for h in self.history])
