"""Typed telemetry records, a copy of ``repro/obs/events.py`` (which
imports no JAX; the port keeps its own so that it imports nothing of
``repro``).

One dataclass per observable fact, each with a ``kind`` tag and a host
wall-clock stamp ``t_wall``. ``to_record(event)`` is a plain-JSON dict
(numpy arrays and torch tensors become lists) and ``event_from_record``
rebuilds the typed event from it. Field names and ``kind`` tags are
JAX's, letter for letter: either package reads the other's JSONL.

``RoundTrace`` phase names (``PHASE_NAMES``) follow one WASGD round: host
staging of the round batch, the tau local steps, the Judge -> theta
policy, the aggregation schedule's reduce phase(s) (``reduce`` for a
one-phase schedule, ``reduce_scatter``/``all_gather`` for the
two-phase ``hierarchical``), the overlap seam thunk, and the Eq. 10
finalize with the state assembly. Phases are filled only by the
phase-fenced round (``detail="phased"``); runs it cannot split
(pipelined rounds, baseline rules) report a fenced ``total_s`` only
(``detail="fused"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

PHASE_NAMES = ("host_staging", "local_steps", "judge", "reduce",
               "reduce_scatter", "overlap", "all_gather", "finalize")


def _now() -> float:
    return time.time()


def _jsonable(v):
    if hasattr(v, "detach"):                     # a torch tensor
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


@dataclasses.dataclass
class RoundTrace:
    """Timing of one training round. ``phases`` maps names of
    ``PHASE_NAMES`` to seconds, each phase fenced (the card synchronized)
    before its timer stops; ``total_s`` is the fenced wall of the round
    on the device, without ``host_staging_s`` (the host's batch pull and
    staging)."""
    kind = "round_trace"
    round: int
    total_s: float
    host_staging_s: float = 0.0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    detail: str = "phased"          # "phased" | "fused"
    p: Optional[int] = None         # live worker count
    t_wall: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class WorkerAssessment:
    """The round's worker assessment: ``theta`` the Eq. 10 weights it
    aggregated with, ``energies`` the workers' energies h that the Judge
    scored, ``active`` the Alg. 4 mask (None in a synchronous round),
    ``policy_state`` a summary of a stateful policy's state (leaf count
    and L2)."""
    kind = "worker_assessment"
    round: int
    theta: List[float]
    energies: List[float]
    theta_entropy: float
    active: Optional[List[bool]] = None
    policy: str = ""
    policy_state: Optional[Dict[str, Any]] = None
    t_wall: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class ServeSample:
    """One ``ContinuousEngine.step()``: ``ttft_s`` the time to first token
    of the requests admitted in it (submit -> first token sampled after
    their prefill), ``e2e_s`` submit-to-finish of those that finished in
    it, ``itl_s`` the chunk's mean inter-token latency (fenced chunk wall
    over its decode steps)."""
    kind = "serve_sample"
    chunk_s: float
    steps: int
    tokens: int
    itl_s: float
    n_running: int
    queue_depth: int
    admitted: int
    finished: int
    blocks_free: int
    blocks_total: int
    occupancy: float
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    e2e_s: List[float] = dataclasses.field(default_factory=list)
    t_wall: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class MembershipChange:
    """A committed ``WorkerSet`` resize at a round boundary."""
    kind = "membership_change"
    round: int
    old_p: int
    new_p: int
    generation: int = 0
    t_wall: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class CheckpointSave:
    """One completed background checkpoint write; ``duration_s`` is the
    writer thread's copy to the host and shard writes."""
    kind = "checkpoint_save"
    path: str
    round: int
    duration_s: float
    nbytes: int
    t_wall: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class HotSwap:
    """One ``HotSwapBridge`` swap and its staleness record: rounds since
    the last swap, tokens served under the previous params, the L2 drift
    the swap closed, the requests in flight."""
    kind = "hot_swap"
    round: int
    rounds_since_last: Optional[int]
    tokens_under_prev: int
    param_drift_l2: float
    in_flight: int
    t_wall: float = dataclasses.field(default_factory=_now)


EVENT_TYPES = {cls.kind: cls for cls in
               (RoundTrace, WorkerAssessment, ServeSample, MembershipChange,
                CheckpointSave, HotSwap)}


def to_record(event) -> Dict[str, Any]:
    """Event -> plain-JSON dict (one JSONL line's payload)."""
    rec = {"kind": event.kind}
    for f in dataclasses.fields(event):
        rec[f.name] = _jsonable(getattr(event, f.name))
    return rec


def event_from_record(rec: Dict[str, Any]):
    """Inverse of ``to_record``. An unknown kind raises; unknown fields of
    a known kind are dropped."""
    rec = dict(rec)
    kind = rec.pop("kind")
    cls = EVENT_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown telemetry event kind {kind!r}; "
                         f"known: {sorted(EVENT_TYPES)}")
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in rec.items() if k in names})


def summarize_policy_state(pstate) -> Optional[Dict[str, Any]]:
    """Leaf count and total L2 (float64) of a policy's carried state, its
    leaves torch tensors or numpy arrays; ``None`` for the empty state of
    a stateless policy."""
    leaves = [_jsonable_array(x) for x in _leaves(pstate)]
    if not leaves:
        return None
    l2 = float(np.sqrt(sum(float(np.sum(np.square(x.astype(np.float64))))
                           for x in leaves)))
    return {"n_leaves": len(leaves), "l2": l2}


def _jsonable_array(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree
