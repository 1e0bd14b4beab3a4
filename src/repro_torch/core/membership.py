"""Elastic worker membership, the counterpart of
``repro/core/membership.py``.

The worker count ``p`` is a property of a ``WorkerSet`` that changes only
at a round boundary, through ``resize(new_p)``, which re-shards every
per-worker structure:

* the worker-stacked params and the optimizer state that mirrors them
  (``core/aggregate.resize_worker_leaves``: survivors bitwise, newcomers
  adopt the aggregate, the Alg. 4 late-join state);
* the worker-assessment policy state (``PipelinePolicy.expand_state``);
* the Alg. 4 activity mask (``core/async_device.resize_active_mask``);
* the loss-energy accumulator (newcomers start at 0).

The slot contract everywhere: worker ``i`` keeps slot ``i`` for
``i < min(old_p, new_p)``; a shrink drops the tail, a grow appends at the
tail.

Under a device mesh (``mesh=``; ``core/shardmap_agg.py``) a rank holds
its shard's rows of every worker-stacked leaf, and both counts must be
multiples of the shard count S. ``resize_train_state(mesh=)`` moves each
leaf's surviving rows to the rank that holds them after the resize, one
leaf at a time (``shardmap_agg.move_rows``), and the newcomers' row is
the all-reduce of the ranks' local sums; the policy state, the Alg. 4
mask and theta are full vectors and resize as without a mesh.

``MembershipSchedule`` scripts the events of a run
(``Trainer.run(membership_schedule=)``) and ``make_chaos_schedule`` draws
a seeded kill/revive walk with numpy, as the JAX package draws it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import shardmap_agg as smagg
from repro_torch.core.aggregate import is_worker_leaf, resize_worker_leaves
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One recorded membership change: ``old_p -> new_p`` at ``round``."""
    round: Optional[int]
    old_p: int
    new_p: int


class WorkerSet:
    """Live worker membership. ``resize`` validates ``p >= 1``, bumps
    ``generation`` on a change and logs every call in ``log``."""

    def __init__(self, p: int):
        if int(p) < 1:
            raise ValueError(f"a WorkerSet needs p >= 1, got {p}")
        self._p = int(p)
        self.generation = 0
        self.log: List[MembershipEvent] = []

    @property
    def p(self) -> int:
        return self._p

    def resize(self, new_p: int, round: Optional[int] = None
               ) -> MembershipEvent:
        """Commits a membership change at a round boundary."""
        new_p = int(new_p)
        if new_p < 1:
            raise ValueError(f"resize needs new_p >= 1, got {new_p}")
        event = MembershipEvent(round, self._p, new_p)
        if new_p != self._p:
            self._p = new_p
            self.generation += 1
        self.log.append(event)
        return event

    def __repr__(self):
        return f"WorkerSet(p={self._p}, generation={self.generation})"


class MembershipSchedule:
    """Round-indexed worker counts: ``events[r] = p`` takes effect at the
    start of round ``r``; ``p_of(r)`` is the latest event at or before
    ``r``, else ``p0``."""

    def __init__(self, p0: int, events: Optional[Dict[int, int]] = None):
        if int(p0) < 1:
            raise ValueError(f"MembershipSchedule needs p0 >= 1, got {p0}")
        self.p0 = int(p0)
        events = dict(events or {})
        for r, p in events.items():
            if int(r) < 0:
                raise ValueError(f"membership event at negative round {r}")
            if int(p) < 1:
                raise ValueError(
                    f"membership event at round {r} asks for p={p}; every "
                    f"round needs >= 1 worker")
        self.events = {int(r): int(p) for r, p in events.items()}
        self._boundaries = sorted(self.events)

    def p_of(self, r: int) -> int:
        p = self.p0
        for b in self._boundaries:
            if b > r:
                break
            p = self.events[b]
        return p

    def max_p(self, n_rounds: int) -> int:
        return max([self.p0] + [p for r, p in self.events.items()
                                if r < n_rounds])

    def __repr__(self):
        ev = ", ".join(f"{r}->{p}" for r, p in sorted(self.events.items()))
        return f"MembershipSchedule(p0={self.p0}, {{{ev}}})"


def make_chaos_schedule(p0: int, rounds: int, seed: int = 0,
                        event_prob: float = 0.4, min_p: int = 1,
                        max_p: Optional[int] = None) -> MembershipSchedule:
    """A seeded kill/revive walk: at each round boundary an event with
    probability ``event_prob`` moves the count by 1 or 2, clamped to
    ``[min_p, max_p]`` (``max_p`` defaults to ``2 * p0``) and biased back
    toward ``p0``."""
    if max_p is None:
        max_p = 2 * p0
    if not (1 <= min_p <= p0 <= max_p):
        raise ValueError(
            f"need 1 <= min_p <= p0 <= max_p, got {min_p}/{p0}/{max_p}")
    rng = np.random.default_rng(seed)
    events: Dict[int, int] = {}
    p = p0
    for r in range(1, rounds):
        if rng.random() >= event_prob:
            continue
        step = int(rng.integers(1, 3))
        direction = -1 if p > p0 else (1 if p < p0 else
                                       (1 if rng.random() < 0.5 else -1))
        new_p = int(np.clip(p + direction * step, min_p, max_p))
        if new_p != p:
            events[r] = new_p
            p = new_p
    return MembershipSchedule(p0, events)


def resize_comm_state(comm_state: Any, new_p: int, policy=None) -> Any:
    """Re-shards a wasgd/wasgd+ ``comm_state``: ``()``, a bare ``(p,)``
    bool mask (stateless Alg. 4), ``{"active", "policy"}`` (stateful Alg.
    4) or a policy state (``policy.expand_state``). The baseline rules'
    states (EASGD's center, MWU's weights) have no elastic re-shard."""
    from repro_torch.core.async_device import resize_active_mask

    if isinstance(comm_state, tuple) and not comm_state:
        return ()
    if isinstance(comm_state, dict) and set(comm_state) == {"active",
                                                            "policy"}:
        pstate = comm_state["policy"]
        if policy is not None:
            pstate = policy.expand_state(pstate, new_p)
        return {"active": resize_active_mask(comm_state["active"], new_p),
                "policy": pstate}
    if isinstance(comm_state, torch.Tensor) and comm_state.dim() == 1 \
            and comm_state.dtype == torch.bool:
        return resize_active_mask(comm_state, new_p)
    if policy is not None and isinstance(comm_state, dict):
        return policy.expand_state(comm_state, new_p)
    raise ValueError(
        "membership resize supports the wasgd/wasgd+ comm_state shapes "
        "((), activity mask, policy state, {'active', 'policy'}); rules "
        "with a center/master variable (easgd, mwu) have no elastic "
        f"re-shard (got {type(comm_state).__name__})")


def _params_like(sub: Any, axes: Any) -> bool:
    """Whether ``sub`` has the structure of the params (``axes``)."""
    if isinstance(axes, dict):
        return isinstance(sub, dict) and set(sub) == set(axes) and all(
            _params_like(sub[k], axes[k]) for k in axes)
    return isinstance(sub, torch.Tensor)


def _resize_params_like(tree: Dict, axes: Dict, new_p: int,
                        mesh=None) -> Dict:
    """Worker leaves sliced or grown (newcomers: the survivor mean), shared
    leaves passed through; under ``mesh`` this rank's rows, moved."""
    def visit(x, ax):
        if not is_worker_leaf(ax):
            return x
        if mesh is not None:
            old_p = x.shape[0] * smagg.mesh_worker_shards(mesh)
            fill = None
            if new_p > old_p:
                fill = smagg.all_reduce_(x.float().sum(0), mesh) / old_p
            return smagg.move_rows(x, new_p, mesh, fill)
        old_p = x.shape[0]
        if new_p <= old_p:
            return x[:new_p]
        fill = x.float().mean(dim=0, keepdim=True).expand(
            new_p - old_p, *x.shape[1:]).to(x.dtype)
        return torch.cat([x, fill])

    return tree_map(visit, tree, axes)


def map_opt_state(fn, opt_state: Any, axes: Dict) -> Any:
    """``fn`` over every params-structured tree of an optimizer state:
    ``()``, such a tree (momentum), or a container of those and scalars
    (AdamW's ``(mu, nu, count)``); scalars pass through."""
    def visit(sub):
        if isinstance(sub, tuple) and not sub:
            return sub
        if _params_like(sub, axes):
            return fn(sub)
        if hasattr(sub, "_fields"):                    # NamedTuple
            return type(sub)(*(visit(getattr(sub, f)) for f in sub._fields))
        if isinstance(sub, (tuple, list)):
            return type(sub)(visit(v) for v in sub)
        if isinstance(sub, torch.Tensor) and sub.dim() == 0:
            return sub
        raise ValueError(
            f"don't know how to re-shard optimizer state of type "
            f"{type(sub).__name__} across a membership resize; expected "
            f"(), a params-structured tree, or a container of those")

    return visit(opt_state)


def resize_opt_state(opt_state: Any, axes: Dict, new_p: int,
                     mesh=None) -> Any:
    """Re-shards optimizer state (``map_opt_state``'s shapes). Worker
    leaves take the survivor mean for newcomers, so a joiner inherits the
    fleet's moments."""
    return map_opt_state(
        lambda sub: _resize_params_like(sub, axes, new_p, mesh), opt_state,
        axes)


def resize_train_state(state, axes: Dict, new_p: int, policy=None,
                       theta: Optional[torch.Tensor] = None,
                       comm_state: Any = "__resize__", mesh=None):
    """Re-shards a ``TrainState``: params through ``resize_worker_leaves``
    (newcomers adopt the aggregate, ``theta``-weighted if given), the
    optimizer state mirrors them, the energies grow with zeros, and the
    comm state goes through ``resize_comm_state`` unless a re-sharded one
    is passed. The round counter carries over. Under ``mesh`` the state
    holds this rank's rows, and so does the result: every rank makes the
    same call, leaf by leaf in the same order."""
    if isinstance(comm_state, str) and comm_state == "__resize__":
        comm_state = resize_comm_state(state.comm_state, new_p,
                                       policy=policy)
    if mesh is not None:
        old_p = state.energy.shape[0] * smagg.mesh_worker_shards(mesh)
        t = (torch.full((old_p,), 1.0 / old_p, dtype=torch.float32,
                        device=state.energy.device) if theta is None
             else theta.float())

        def worker_rows(x, ax):
            if not is_worker_leaf(ax):
                return x
            fill = (smagg.all_reduce_m_phase(x, t, mesh) if new_p > old_p
                    else None)
            return smagg.move_rows(x, new_p, mesh, fill)

        return state._replace(
            params=tree_map(worker_rows, state.params, axes),
            opt_state=resize_opt_state(state.opt_state, axes, new_p, mesh),
            energy=smagg.move_rows(state.energy, new_p, mesh),
            comm_state=comm_state)
    old_energy = state.energy
    old_p = old_energy.shape[0]
    if new_p <= old_p:
        energy = old_energy[:new_p]
    else:
        energy = torch.cat([old_energy, old_energy.new_zeros(new_p - old_p)])
    return state._replace(
        params=resize_worker_leaves(state.params, axes, new_p, theta=theta),
        opt_state=resize_opt_state(state.opt_state, axes, new_p),
        energy=energy,
        comm_state=comm_state,
    )


def resized_template(state, axes: Dict, new_p: int, policy=None,
                     mesh=None):
    """A ``TrainState`` with ``state``'s structure, dtypes and device at
    ``new_p`` workers (this rank's rows under ``mesh``), the target a
    restore at ``new_p`` fills: its worker leaves are views of one
    element (no memory), its comm state resized."""
    n = smagg.local_workers(new_p, mesh)

    def rows(x, worker=True):
        return (x.new_empty(()).expand((n,) + tuple(x.shape[1:]))
                if worker else x)

    def params_like(tree):
        return tree_map(lambda x, ax: rows(x, is_worker_leaf(ax)), tree, axes)

    return state._replace(
        params=params_like(state.params),
        opt_state=map_opt_state(params_like, state.opt_state, axes),
        energy=rows(state.energy),
        comm_state=resize_comm_state(state.comm_state, new_p, policy=policy))
