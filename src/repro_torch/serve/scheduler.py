"""Continuous-batching scheduler: FIFO admission queue, batch-slot
recycling, per-request insertion into and eviction from the running batch
at token boundaries. A copy of ``repro/serve/scheduler.py``, which is pure
numpy: the port keeps its own so that it imports nothing of ``repro``.

The scheduler is pure bookkeeping and owns no device state. The engine
asks it which request to admit next (``next_admit``), binds a free slot
(``admit``), and returns finished requests to it (``evict``); the paged
cache separately gates admission on block availability.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from time import perf_counter
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (s,) int32
    n_new: int
    temperature: float = 0.0
    seed: int = 0
    tokens: List[int] = field(default_factory=list)   # generated so far
    slot: Optional[int] = None
    # host wall-clock marks (perf_counter domain) for latency telemetry:
    # submission, and first-token readiness (set by the engine at the end
    # of the request's prefill when a telemetry sink is attached).
    t_submit: float = field(default_factory=perf_counter)
    t_first: Optional[float] = None

    @property
    def total_budget(self) -> int:
        return len(self.prompt) + self.n_new

    @property
    def done(self) -> bool:
        """Budget spent. A request can also finish early on a stop token —
        eviction is the authoritative signal, this is a convenience."""
        return len(self.tokens) >= self.n_new


class Scheduler:
    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self.finished: Dict[int, Request] = {}     # rid -> request
        self._free_slots: List[int] = list(range(n_slots))
        self._next_rid = 0

    def submit(self, prompt: np.ndarray, n_new: int,
               temperature: float = 0.0, seed: int = 0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid,
                                  prompt=np.asarray(prompt, np.int32),
                                  n_new=int(n_new),
                                  temperature=float(temperature),
                                  seed=int(seed)))
        return rid

    # -- admission ----------------------------------------------------------

    def has_free_slot(self) -> bool:
        return bool(self._free_slots)

    def next_admit(self) -> Optional[Request]:
        """Peek the request that would be admitted next (FIFO)."""
        if self.queue and self._free_slots:
            return self.queue[0]
        return None

    def admit(self) -> Request:
        """Bind the head-of-queue request to a free slot."""
        req = self.queue.popleft()
        req.slot = self._free_slots.pop()
        self.running[req.slot] = req
        return req

    # -- completion ---------------------------------------------------------

    def evict(self, slot: int) -> Request:
        """Remove a finished (or cancelled) request and recycle its slot."""
        req = self.running.pop(slot)
        req.slot = None
        self._free_slots.append(slot)
        self.finished[req.rid] = req
        return req

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running
