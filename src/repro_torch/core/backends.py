"""Two-axis aggregation API: collective *schedule* x payload *codec*, the
counterpart of ``repro/core/backends.py``. ``WASGDConfig.backend`` takes

    "<schedule>:<codec>"        e.g. "rs_ag:int8", "hierarchical:bf16"

a bare ``"<schedule>"`` (codec from ``ctx.comm_dtype``), a legacy alias,
or ``"auto"`` (``select_auto_spec``: the spec per worker-leaf bytes and
mesh size, from a recorded table or a size heuristic).

Schedules:

``einsum``        the reference: tensordot over the worker axis, then the
                  FMA (``fma_late_join``).
``hierarchical``  pod-local reduce in the codec's reduce dtype, then a
                  float32 cross-pod reduce. Needs ``ctx.n_pods >= 2``
                  dividing the worker count.
``shard_map``     an explicit ``all_reduce`` over the mesh's worker group
                  (``core/shardmap_agg.py``). One reduce phase. Needs
                  ``ctx.mesh``.
``rs_ag``         reduce-scatter (phase 1) + all-gather (phase 2) + local
                  FMA, the partial in the codec's wire dtype. The
                  reduce-scatter is issued asynchronously and the
                  all-gather waits on it: the ``overlap=`` thunk runs in
                  between. Needs ``ctx.mesh``.
``pallas_wagg``   the fused kernel (``kernels/wagg``): codec decode, the
                  Alg. 4 mask and the Eq. 10 FMA in one pass, by the CUDA
                  kernel on a CUDA tensor (its plain version on the CPU).
                  Meshless, a tree's worker leaves go to the kernel
                  together, in grouped launches. The name is the JAX
                  package's, so configs carry over.

Under a mesh (``ctx.mesh``, a ``torch.distributed`` ``DeviceMesh``) each
rank's worker leaves hold the rows of its shard, while theta and
``ctx.active`` are the full ``(w,)`` vectors (``core/shardmap_agg.py``).
The meshless schedules give the same numbers there as without a mesh:
each leaf's rows are all-gathered over the worker group, the schedule
runs on the whole leaf, and the rank keeps its rows. That is what XLA's
derived collective does on JAX's sharded array.

Every schedule runs ``prepare -> reduce_phase(i) for i < n_phases ->
finalize`` for each worker leaf. Without an ``overlap=`` thunk the
backend takes one leaf through all of that before the next, so one leaf's
reduce state is alive at a time; meshless ``pallas_wagg`` instead encodes
leaf by leaf and hands its grouped kernel the leaves in batches whose
payloads stay within ``WAGG_PAYLOAD_CAP`` (f32: no payload, one batch for
the tree; ``payload_batches``), and ``PhaseMajor.finalize`` hands it every
leaf. With a thunk it runs as the JAX package
does: every leaf's prepare and phase 0, then the thunk (between the two
collectives of ``rs_ag`` and the two hops of ``hierarchical``; after the
one phase of the others), then the later phases and every finalize. Each
leaf's arithmetic is the same either way, so the params are too; the
thunk's result comes back beside them and never feeds the aggregate.

Adding a schedule (``register_schedule``) or a monolithic backend
``fn(params, axes, theta, beta, ctx)`` (``register_backend``) works as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import dtype_of
from repro_torch.core import shardmap_agg as smagg
from repro_torch.core.aggregate import fma_late_join, is_worker_leaf
from repro_torch.core.codecs import (available_codecs, codec_for_dtype,
                                     get_codec)
from repro_torch.obs.spans import span
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AggregationContext:
    """Knobs every schedule and codec receives.

    ``mesh``       the ``DeviceMesh`` of the schedules that place explicit
                   collectives (``None``: one process holds every worker).
    ``comm_dtype`` payload dtype for specs that leave the codec open.
    ``n_pods``     pod count of the hierarchical 2-hop.
    ``active``     (w,) Alg. 4 activity mask, bool or float32 0/1 (the
                   kernel's form, which the Alg. 4 rule casts once a
                   round); ``None``: all active.
    ``key``        integer seed of stochastic codecs (``int4``); ``None``:
                   the codec's fixed default.
    ``leaf_index`` position of the current leaf in the flattened tree, set
                   per leaf by ``ComposedBackend.aggregate`` so that
                   stochastic codecs draw distinct noise for equal-content
                   leaves.
    """
    mesh: Optional[object] = None
    comm_dtype: torch.dtype = torch.float32
    n_pods: int = 1
    active: Optional[torch.Tensor] = None
    key: Optional[int] = None
    leaf_index: Optional[int] = None


DEFAULT_CONTEXT = AggregationContext()


def _needs_mesh_error(name: str) -> ValueError:
    return ValueError(
        f"aggregation backend {name!r} places explicit collectives and "
        f"needs ctx.mesh (pass mesh= through communicate/wasgd_rule, or "
        f"use the 'einsum' family)")


class _FnBackend:
    """A plain ``fn(params, axes, theta, beta, ctx)`` as a backend (the
    monolithic escape hatch of ``register_backend``)."""

    def __init__(self, name: str, fn: Callable, needs_mesh: bool = False):
        self.name = name
        self.needs_mesh = needs_mesh
        self._fn = fn

    def aggregate(self, params, axes, theta, beta, *,
                  ctx: AggregationContext = DEFAULT_CONTEXT):
        if self.needs_mesh and ctx.mesh is None:
            raise _needs_mesh_error(self.name)
        return self._fn(params, axes, theta, beta, ctx)

    def __repr__(self):
        return f"AggregatorBackend({self.name!r})"


# ---------------------------------------------------------------------------
# Built-in schedules
# ---------------------------------------------------------------------------

def _encode(codec, x, ctx):
    """A leaf's payload and aux from the codec, under the ``agg.encode``
    span."""
    with span("agg.encode"):
        return codec.encode(x, ctx)


class _EinsumSchedule:
    name = "einsum"
    needs_mesh = False
    n_phases = 1
    codecs = None
    supports_mask = True

    def prepare(self, x, theta, codec, ctx):
        payload, aux = _encode(codec, x, ctx)
        return {"payload": payload, "aux": aux}

    def reduce_phase(self, i, state, theta, codec, ctx):
        rd = codec.reduce_dtype
        m = torch.tensordot(theta.to(rd), state["payload"].to(rd),
                            dims=1).float()
        return {"m": m, "aux": state["aux"]}

    def finalize(self, state, x, theta, beta, codec, ctx):
        m = codec.decode_reduced(state["m"], state["aux"])
        return fma_late_join(x, m, beta, ctx.active)


class _HierarchicalSchedule:
    name = "hierarchical"
    needs_mesh = False
    n_phases = 2
    codecs = None
    supports_mask = True

    def validate(self, theta, ctx):
        w = theta.shape[0]
        if ctx.n_pods < 2 or w % ctx.n_pods:
            raise ValueError(
                f"'hierarchical' schedule needs ctx.n_pods >= 2 dividing the "
                f"worker count (got n_pods={ctx.n_pods}, workers={w}); set "
                f"WASGDConfig.n_pods or use the 'einsum' schedule")

    def prepare(self, x, theta, codec, ctx):
        payload, aux = _encode(codec, x, ctx)
        w = payload.shape[0]
        xr = payload.reshape(ctx.n_pods, w // ctx.n_pods, *payload.shape[1:])
        return {"xr": xr, "aux": aux}

    def reduce_phase(self, i, state, theta, codec, ctx):
        if i == 0:                                   # pod-local hop
            rd = codec.reduce_dtype
            tr = theta.reshape(ctx.n_pods, -1)
            partial = torch.einsum("pw...,pw->p...", state["xr"].to(rd),
                                   tr.to(rd))
            return {"partial": partial, "aux": state["aux"]}
        m = state["partial"].float().sum(dim=0)      # cross-pod hop
        return {"m": m, "aux": state["aux"]}

    def finalize(self, state, x, theta, beta, codec, ctx):
        m = codec.decode_reduced(state["m"], state["aux"])
        return fma_late_join(x, m, beta, ctx.active)


class _ShardMapSchedule:
    """An explicit all-reduce over the mesh's worker group. One reduce
    phase."""
    name = "shard_map"
    needs_mesh = True
    n_phases = 1
    codecs = None
    supports_mask = True

    def prepare(self, x, theta, codec, ctx):
        payload, aux = _encode(codec, x, ctx)
        return {"payload": payload, "aux": aux}

    def reduce_phase(self, i, state, theta, codec, ctx):
        m = smagg.all_reduce_m_phase(state["payload"], theta, ctx.mesh,
                                     reduce_dtype=codec.reduce_dtype)
        return {"m": m, "aux": state["aux"]}

    def finalize(self, state, x, theta, beta, codec, ctx):
        m = codec.decode_reduced(state["m"], state["aux"])
        return fma_late_join(x, m, beta, smagg.local_active(
            ctx.active, x.shape[0], ctx.mesh))


class _RsAgSchedule:
    """reduce-scatter (phase 1) + all-gather (phase 2) + local FMA. Dtype
    codecs pin the ring partial to their wire dtype; quantizing codecs
    encode the operand and let the partial ride in ``reduce_dtype`` (a
    partial sum of integer payloads is fractional). Phase 1 leaves the
    reduce-scatter in flight; phase 2 waits on it."""
    name = "rs_ag"
    needs_mesh = True
    n_phases = 2
    codecs = None
    supports_mask = True

    def prepare(self, x, theta, codec, ctx):
        s = smagg.mesh_worker_shards(ctx.mesh)
        if codec.quantizing:
            payload, aux = _encode(codec, x, ctx)
            wire = codec.reduce_dtype
        else:
            payload, aux = x, None
            wire = codec.wire_dtype
        flat, n = smagg.flatten_pad(payload, s)
        return {"flat": flat, "aux": aux, "n": n, "wire": wire}

    def reduce_phase(self, i, state, theta, codec, ctx):
        if i == 0:
            m_scat, work = smagg.reduce_scatter_phase(
                state.pop("flat"), theta, ctx.mesh,
                wire_dtype=state["wire"], async_op=True)
            return {**state, "m_scat": m_scat, "work": work}
        m = smagg.all_gather_phase(state.pop("m_scat"), ctx.mesh,
                                   work=state.pop("work"))
        return {**state, "m": m}

    def finalize(self, state, x, theta, beta, codec, ctx):
        m = codec.decode_reduced(state["m"], state["aux"])
        flat_x, n = smagg.flatten_pad(x, smagg.mesh_worker_shards(ctx.mesh))
        out = fma_late_join(flat_x, m, beta, smagg.local_active(
            ctx.active, x.shape[0], ctx.mesh))
        return out[:, :n].reshape(x.shape)


# payload bytes a batch of the grouped pallas_wagg aggregate may hold (or
# the largest leaf's payload, if that is larger)
WAGG_PAYLOAD_CAP = 256 << 20


class _PallasWaggSchedule:
    """The fused kernel: the codec's payload rides into it as-is (its
    per-leaf scale folded into theta inside the kernel) and is widened to
    float32 in the same pass as the mask and the FMA. Meshless, every
    worker leaf of a tree goes to ``finalize_many`` at once
    (``aggregate_leaves``), which runs them in grouped launches."""
    name = "pallas_wagg"
    needs_mesh = False
    n_phases = 1
    codecs = ("f32", "bf16", "int8", "int4")
    supports_mask = True

    def prepare(self, x, theta, codec, ctx):
        if codec.name == "f32":
            return {"payload": None, "aux": None}    # the kernel reads x once
        payload, aux = _encode(codec, x, ctx)
        return {"payload": payload, "aux": aux}

    def reduce_phase(self, i, state, theta, codec, ctx):
        return state               # the fused kernel is the reduce

    def finalize(self, state, x, theta, beta, codec, ctx):
        return self.finalize_many([state], [x], theta, beta, codec, ctx)[0]

    def finalize_many(self, states, xs, theta, beta, codec, ctx):
        from repro_torch.kernels.wagg.ops import wagg_fused_leaves
        return wagg_fused_leaves(xs, [st["payload"] for st in states],
                                 [st["aux"] for st in states], theta, beta,
                                 active=ctx.active)

    def aggregate_leaves(self, xs, ctxs, theta, beta, codec):
        """Every worker leaf, encoded one by one in the flatten order
        (``ctxs[i].leaf_index``) and handed to ``finalize_many`` a batch
        at a time (``payload_batches``): the f32 codec has no payload, so
        one call takes the whole tree."""
        sizes = [payload_bytes(x.numel(), codec.name, codec.wire_dtype)
                 for x in xs]
        outs = []
        for batch in payload_batches(sizes):
            states = [self.prepare(xs[i], theta, codec, ctxs[i])
                      for i in batch]
            outs.extend(self.finalize_many(states, [xs[i] for i in batch],
                                           theta, beta, codec, ctxs[0]))
            del states                  # one batch's payloads at a time
        return outs


def payload_bytes(numel: int, codec_name: str, wire_dtype) -> int:
    """Bytes of a leaf's ``pallas_wagg`` payload (0 for f32: x is its own
    payload)."""
    return 0 if codec_name == "f32" else numel * wire_dtype.itemsize


def payload_batches(sizes) -> list:
    """The leaves of a meshless ``pallas_wagg`` aggregate cut, in the
    flatten order, into runs whose payload bytes (``sizes``) stay within
    ``WAGG_PAYLOAD_CAP``, or within the largest leaf's payload where that
    is larger: what the grouped aggregate may hold beyond the leaf-by-leaf
    one."""
    cap = max([WAGG_PAYLOAD_CAP, *sizes])
    batches, held = [], cap + 1
    for i, nbytes in enumerate(sizes):
        if held + nbytes > cap:
            batches.append([])
            held = 0
        batches[-1].append(i)
        held += nbytes
    return batches


def pallas_wagg_plan(leaves, codec_name: str) -> list:
    """The kernel launches of one meshless ``pallas_wagg:<codec_name>``
    aggregate, as lists of worker-leaf positions: ``leaves`` the worker
    leaves' (numel, dtype) in the flatten order. Each payload batch goes to
    ``wagg_fused_many``, which groups its leaves by (x dtype, payload)
    into launches of at most ``MAX_LEAVES`` (``group_plan``); a payload is
    x itself for f32, and for bf16 on bfloat16 x."""
    from repro_torch.kernels.wagg.wagg import group_plan
    codec = get_codec(codec_name)
    out = []
    for batch in payload_batches([payload_bytes(n, codec_name,
                                                codec.wire_dtype)
                                  for n, _ in leaves]):
        keys = []
        for i in batch:
            dtype = leaves[i][1]
            same = codec_name == "f32" or (not codec.quantizing
                                           and codec.wire_dtype == dtype)
            keys.append((dtype, None if same else codec.wire_dtype))
        out.extend([batch[j] for j in group] for group in group_plan(keys))
    return out


class _Gathered:
    """A meshless schedule under a mesh: each leaf's rows are gathered
    over the worker group, the schedule runs on the whole leaf without
    the mesh, and this rank keeps its rows of the result. The gather and
    the whole inner schedule run in ``finalize``, so a phase-major run
    holds one leaf's gathered rows at a time, never the whole tree's."""
    n_phases = 1

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name

    def validate(self, theta, ctx):
        validate = getattr(self.inner, "validate", None)
        if validate is not None:
            validate(theta, ctx)

    def prepare(self, x, theta, codec, ctx):
        return None

    def reduce_phase(self, i, state, theta, codec, ctx):
        return state

    def finalize(self, state, x, theta, beta, codec, ctx):
        full = smagg.gather_rows(x, ctx.mesh)
        meshless = dataclasses.replace(ctx, mesh=None)
        inner = self.inner.prepare(full, theta, codec, meshless)
        for phase in range(self.inner.n_phases):
            inner = self.inner.reduce_phase(phase, inner, theta, codec,
                                            meshless)
        out = self.inner.finalize(inner, full, theta, beta, codec, meshless)
        if full.shape[0] == x.shape[0]:          # one shard: every row
            return out
        return out[smagg.local_rows(full.shape[0], ctx.mesh)].clone()


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

_SCHEDULES: Dict[str, object] = {}
_REGISTRY: Dict[str, object] = {}                # monolithic backends
_COMPOSED: Dict[str, "ComposedBackend"] = {}     # resolved spec cache

# old name -> (schedule, codec or None); None: codec from ctx.comm_dtype
_ALIASES: Dict[str, Tuple[str, Optional[str]]] = {
    "einsum": ("einsum", None),
    "quantized": ("einsum", "int8"),
    "hierarchical": ("hierarchical", None),
    "shard_map": ("shard_map", "f32"),
    "rs_ag": ("rs_ag", None),
    "pallas_wagg": ("pallas_wagg", "f32"),
    # Alg. 4 family: the same schedules; every one honours ctx.active
    "async_einsum": ("einsum", None),
    "async_shard_map": ("shard_map", "f32"),
    "async_rs_ag": ("rs_ag", None),
}


def register_schedule(schedule, *, overwrite: bool = False):
    """Registers a schedule (instance or class) by its name: every
    ``"<name>:<codec>"`` spec becomes selectable."""
    obj = schedule() if isinstance(schedule, type) else schedule
    if obj.name in _SCHEDULES and not overwrite:
        raise ValueError(f"aggregation schedule {obj.name!r} already "
                         f"registered; pass overwrite=True to replace")
    _SCHEDULES[obj.name] = obj
    _COMPOSED.clear()
    return schedule


def register_backend(name: str, fn: Optional[Callable] = None, *,
                     needs_mesh: bool = False, overwrite: bool = False):
    """Registers a monolithic backend under ``name``: as a decorator over
    ``fn(params, axes, theta, beta, ctx)``, or called with ``fn`` (or an
    object with an ``aggregate`` method)."""
    def _register(obj):
        taken = name in _REGISTRY or name in _ALIASES or name in _SCHEDULES
        if taken and not overwrite:
            raise ValueError(f"aggregation backend {name!r} already "
                             f"registered; pass overwrite=True to replace")
        if hasattr(obj, "aggregate"):
            backend = obj
            if needs_mesh and not getattr(obj, "needs_mesh", False):
                backend = _FnBackend(
                    name, lambda p, a, t, b, ctx: obj.aggregate(p, a, t, b,
                                                                ctx=ctx),
                    needs_mesh=True)
        else:
            backend = _FnBackend(name, obj, needs_mesh=needs_mesh)
        _REGISTRY[name] = backend
        return obj

    if fn is not None:
        return _register(fn)
    return _register


for _s in (_EinsumSchedule(), _HierarchicalSchedule(), _ShardMapSchedule(),
           _RsAgSchedule(), _PallasWaggSchedule()):
    register_schedule(_s)


# ---------------------------------------------------------------------------
# Spec resolution and the composed backend
# ---------------------------------------------------------------------------

def resolve_spec(name: str) -> Tuple[str, Optional[str]]:
    """``alias | schedule | schedule:codec`` -> (schedule, codec or None).
    Raises ``KeyError`` with the known names for anything unresolvable."""
    if name in _ALIASES:
        return _ALIASES[name]
    if ":" in name:
        sched, codec = name.split(":", 1)
        if sched not in _SCHEDULES:
            raise KeyError(
                f"unknown aggregation schedule {sched!r} in spec {name!r}; "
                f"known schedules: {sorted(_SCHEDULES)}")
        if codec not in available_codecs():
            raise KeyError(
                f"unknown payload codec {codec!r} in spec {name!r}; "
                f"known codecs: {list(available_codecs())}")
        return sched, codec
    if name in _SCHEDULES:
        return name, None
    raise KeyError(
        f"unknown aggregation backend {name!r}; known names: "
        f"{sorted(set(_ALIASES) | set(_REGISTRY))}, or compose a "
        f"'<schedule>:<codec>' spec from schedules {sorted(_SCHEDULES)} x "
        f"codecs {list(available_codecs())}")


def canonical_spec(name: str) -> str:
    """An alias or spec in ``schedule[:codec]`` form."""
    sched, codec = resolve_spec(name)
    return sched if codec is None else f"{sched}:{codec}"


class ComposedBackend:
    """schedule x codec: ``aggregate(params, axes, theta, beta, ctx=)``
    applies Eq. 10 to every worker leaf. With ``overlap=`` (a nullary
    thunk, its result any tree) the return value is ``(params,
    overlap_result)`` and the thunk runs after every leaf's phase 0."""

    def __init__(self, schedule, codec_name: Optional[str], name: str):
        self.schedule = schedule
        self.codec_name = codec_name
        self.name = name
        self.needs_mesh = schedule.needs_mesh

    def _codec(self, ctx: AggregationContext):
        codec = (get_codec(self.codec_name) if self.codec_name
                 else codec_for_dtype(ctx.comm_dtype))
        supported = getattr(self.schedule, "codecs", None)
        if supported is not None and codec.name not in supported:
            raise ValueError(
                f"schedule {self.schedule.name!r} composes only with codecs "
                f"{list(supported)}, not {codec.name!r} "
                f"(spec {self.name!r})")
        return codec

    def _resolve(self, theta, ctx: AggregationContext):
        """The codec and the schedule to run in ``ctx`` (a meshless one
        under a mesh runs gathered), validated."""
        if self.needs_mesh and ctx.mesh is None:
            raise _needs_mesh_error(self.name)
        codec = self._codec(ctx)
        sched = self.schedule
        if ctx.mesh is not None:
            smagg.check_mesh(ctx.mesh)
            if not sched.needs_mesh:
                sched = _Gathered(sched)
        validate = getattr(sched, "validate", None)
        if validate is not None:
            validate(theta, ctx)
        return codec, sched

    def aggregate(self, params: Dict, axes: Dict, theta: torch.Tensor, beta,
                  *, ctx: AggregationContext = DEFAULT_CONTEXT,
                  overlap: Optional[Callable] = None):
        codec, sched = self._resolve(theta, ctx)
        theta = theta.float()
        if overlap is not None:             # phase-major, the thunk between
            run = PhaseMajor(sched, codec, params, axes, theta, ctx)
            run.reduce(0)
            overlap_out = overlap()
            for phase in range(1, sched.n_phases):
                run.reduce(phase)
            return run.finalize(beta), overlap_out
        if hasattr(sched, "aggregate_leaves"):   # every leaf at once
            index, xs = _worker_items(params, axes)
            outs = sched.aggregate_leaves(
                xs, [dataclasses.replace(ctx, leaf_index=i) for i in index],
                theta, beta, codec)
            return _replace_worker_leaves(params, axes, dict(zip(index,
                                                                 outs)))
        position = itertools.count()

        def leaf(x, ax):
            i = next(position)              # the flatten order: sorted keys
            if not is_worker_leaf(ax):
                return x
            lctx = dataclasses.replace(ctx, leaf_index=i)
            state = sched.prepare(x, theta, codec, lctx)
            for phase in range(sched.n_phases):
                state = sched.reduce_phase(phase, state, theta, codec, lctx)
            return sched.finalize(state, x, theta, beta, codec, lctx)

        return tree_map(leaf, params, axes)

    def phase_major(self, params: Dict, axes: Dict, theta: torch.Tensor,
                    *, ctx: AggregationContext = DEFAULT_CONTEXT
                    ) -> "PhaseMajor":
        """The aggregate split into its phases, for a caller that runs
        them one by one (the phase-fenced round)."""
        codec, sched = self._resolve(theta, ctx)
        return PhaseMajor(sched, codec, params, axes, theta.float(), ctx)

    def __repr__(self):
        return f"ComposedBackend({self.name!r})"


class PhaseMajor:
    """One phase-major aggregate: ``reduce(0)`` prepares every worker leaf
    and runs its first reduce phase, ``reduce(k)`` the later phases leaf
    by leaf, ``finalize(beta)`` the Eq. 10 FMA of every leaf and returns
    the new tree. Every leaf's reduce state is alive between the phases
    (for ``einsum`` a float32 mean of each leaf), which is why the
    aggregate without a thunk goes leaf by leaf instead."""

    def __init__(self, sched, codec, params, axes, theta, ctx):
        self.sched, self.codec, self.theta = sched, codec, theta
        self.params, self.axes, self.ctx = params, axes, ctx
        index, xs = _worker_items(params, axes)
        self.xs = dict(zip(index, xs))
        self.ctxs = {i: dataclasses.replace(ctx, leaf_index=i)
                     for i in index}
        self.states: Dict[int, object] = {}

    def reduce(self, phase: int) -> None:
        sched, codec, theta = self.sched, self.codec, self.theta
        if phase == 0:
            self.states = {i: sched.prepare(x, theta, codec, self.ctxs[i])
                           for i, x in self.xs.items()}
        self.states = {i: sched.reduce_phase(phase, st, theta, codec,
                                             self.ctxs[i])
                       for i, st in self.states.items()}

    def finalize(self, beta) -> Dict:
        many = getattr(self.sched, "finalize_many", None)
        if many is not None:                # every leaf's state is alive
            index = list(self.xs)
            outs = many([self.states.pop(i) for i in index],
                        [self.xs[i] for i in index], self.theta, beta,
                        self.codec, self.ctx)
            return _replace_worker_leaves(self.params, self.axes,
                                          dict(zip(index, outs)))
        position = itertools.count()

        def leaf(x, ax):
            i = next(position)
            if not is_worker_leaf(ax):
                return x
            return self.sched.finalize(self.states.pop(i), x, self.theta,
                                       beta, self.codec, self.ctxs[i])

        return tree_map(leaf, self.params, self.axes)


def _worker_items(params: Dict, axes: Dict):
    """(flatten positions, leaves) of the worker leaves, in the flatten
    order (sorted keys)."""
    items = [(i, x) for i, (x, ax) in enumerate(zip(tree_leaves(params),
                                                     tree_leaves(axes)))
             if is_worker_leaf(ax)]
    return [i for i, _ in items], [x for _, x in items]


def _replace_worker_leaves(params: Dict, axes: Dict, new: Dict) -> Dict:
    """``params`` with the worker leaf at each flatten position of ``new``
    replaced."""
    position = itertools.count()
    return tree_map(lambda x, ax: new.get(next(position), x), params, axes)


def get_backend(name: str):
    if name in _REGISTRY:                 # monolithic ones win their name
        return _REGISTRY[name]
    if name == "auto":
        raise KeyError(
            "backend 'auto' is resolved per parameter tree; go through "
            "aggregate_from_config, or call select_auto_spec(params, axes, "
            "mesh) and get_backend the result")
    if name not in _COMPOSED:
        sched_name, codec_name = resolve_spec(name)
        _COMPOSED[name] = ComposedBackend(_SCHEDULES[sched_name], codec_name,
                                          name)
    return _COMPOSED[name]


def available_backends() -> Tuple[str, ...]:
    """Selectable names (aliases and monolithic registrations); the full
    grid is ``available_specs()``."""
    return tuple(sorted(set(_ALIASES) | set(_REGISTRY)))


def available_schedules() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEDULES))


def available_specs() -> Tuple[str, ...]:
    """Every composable ``schedule:codec`` spec."""
    out = []
    for s in sorted(_SCHEDULES):
        supported = getattr(_SCHEDULES[s], "codecs", None)
        for c in available_codecs():
            if supported is None or c in supported:
                out.append(f"{s}:{c}")
    return tuple(out)


def aggregate_with(name: str, params: Dict, axes: Dict, theta: torch.Tensor,
                   beta, *, ctx: AggregationContext = DEFAULT_CONTEXT,
                   overlap: Optional[Callable] = None):
    """``get_backend(name).aggregate(...)``; with ``overlap=`` the return
    value is ``(params, overlap_result)`` (a monolithic backend runs the
    thunk after its aggregate)."""
    backend = get_backend(name)
    if isinstance(backend, ComposedBackend):
        return backend.aggregate(params, axes, theta, beta, ctx=ctx,
                                 overlap=overlap)
    out = backend.aggregate(params, axes, theta, beta, ctx=ctx)
    return out if overlap is None else (out, overlap())


def aggregate_from_config(wcfg, params: Dict, axes: Dict,
                          theta: torch.Tensor, *, beta=None, mesh=None,
                          overlap: Optional[Callable] = None):
    """Eq. 10 with the backend and context a ``WASGDConfig`` selects
    (``"auto"`` per parameter tree); ``beta`` defaults to ``wcfg.beta``;
    ``overlap`` as in ``aggregate_with``."""
    beta = wcfg.beta if beta is None else beta
    name = backend_name_from_config(wcfg)
    if name == "auto":
        name = select_auto_spec(params, axes, mesh, n_pods=wcfg.n_pods)
    return aggregate_with(name, params, axes, theta, beta,
                          ctx=context_from_config(wcfg, mesh),
                          overlap=overlap)


def backend_name_from_config(wcfg) -> str:
    """An explicit ``wcfg.backend`` wins; otherwise the legacy booleans
    compose: ``hierarchical`` > ``sharded_aggregate`` (rs_ag) > einsum for
    the schedule, ``quantize_comm`` for the int8 codec."""
    explicit = getattr(wcfg, "backend", "")
    if explicit:
        return explicit
    sched = "einsum"
    if wcfg.hierarchical:
        if wcfg.n_pods < 2:
            raise ValueError(
                "WASGDConfig(hierarchical=True) with n_pods < 2 is a "
                "degenerate 2-hop; set n_pods >= 2 dividing the worker "
                "count, or drop hierarchical=True")
        if wcfg.sharded_aggregate:
            warnings.warn(
                "hierarchical=True and sharded_aggregate=True name two "
                "different schedules; taking 'hierarchical' (the legacy "
                "priority) — set WASGDConfig.backend to an explicit "
                "'<schedule>:<codec>' spec to silence this", stacklevel=2)
        sched = "hierarchical"
    elif wcfg.sharded_aggregate:
        sched = "rs_ag"
    if wcfg.quantize_comm:
        return f"{sched}:int8"
    return sched


def context_from_config(wcfg, mesh=None) -> AggregationContext:
    return AggregationContext(mesh=mesh, comm_dtype=dtype_of(wcfg.comm_dtype),
                              n_pods=wcfg.n_pods)


# ---------------------------------------------------------------------------
# backend="auto": measurement-driven spec selection
# ---------------------------------------------------------------------------

# the repo root (this file is src/repro_torch/core/backends.py)
REPO_ROOT = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, os.pardir))
AUTO_BENCH_PATH = os.path.join(REPO_ROOT, "results",
                               "BENCH_backend_matrix.json")

# nearest-measurement cutoff (log-space distance over bytes x mesh size):
# about a 20x mismatch, past which the size heuristic decides
AUTO_MAX_LOG_DIST = 3.0

_MISSING_TABLE_WARNED = set()
_AUTO_TABLE_CACHE: Dict = {}


def _load_auto_table(path: str):
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    key = (os.path.abspath(path), mtime)
    if key not in _AUTO_TABLE_CACHE:
        _AUTO_TABLE_CACHE.clear()
        try:
            with open(path) as f:
                _AUTO_TABLE_CACHE[key] = json.load(f).get("records", [])
        except (OSError, ValueError):
            _AUTO_TABLE_CACHE[key] = None
    return _AUTO_TABLE_CACHE[key]


def _worker_leaves(params: Dict, axes: Dict):
    return _worker_items(params, axes)[1]


def worker_leaf_bytes(params: Dict, axes: Dict) -> int:
    """Bytes of this process's worker-stacked leaves: the payload the
    auto-selector sizes the schedule against (times the mesh's shards
    under a mesh)."""
    return sum(x.numel() * x.element_size()
               for x in _worker_leaves(params, axes))


def _spec_runnable(sched_name: str, mesh, n_pods: int, w: Optional[int],
                   require_mask: bool) -> bool:
    """Whether the schedule can run here: mesh schedules need a mesh whose
    worker shards divide w, hierarchical needs pods, and the Alg. 4
    rounds need a masked (late-join) path."""
    sched = _SCHEDULES[sched_name]
    if require_mask and not getattr(sched, "supports_mask", True):
        return False
    if sched_name == "hierarchical" and (
            n_pods < 2 or (w is not None and w % n_pods)):
        return False
    if sched.needs_mesh:
        if mesh is None:
            return False
        if w is not None and w % smagg.mesh_worker_shards(mesh):
            return False
    return True


def select_auto_spec(params: Dict, axes: Dict, mesh=None,
                     table_path: Optional[str] = None, n_pods: int = 1,
                     require_mask: bool = False) -> str:
    """``backend="auto"``: a ``schedule:codec`` spec for this tree.

    Among the table's non-overlap records (``table_path``, default
    ``AUTO_BENCH_PATH``; a missing table warns once per path) whose
    (payload bytes, mesh devices) point is nearest in log-space to this
    tree's, and within ``AUTO_MAX_LOG_DIST`` of it, the fastest spec that
    can run here (``_spec_runnable``). Otherwise a size heuristic: a tree
    under 4 MiB takes ``einsum:f32``, a larger one ``rs_ag:bf16`` on a
    mesh of more than one device and ``einsum:bf16`` without. Under a
    mesh the bytes and the worker count are the whole tree's (every
    shard's rows)."""
    table_path = AUTO_BENCH_PATH if table_path is None else table_path
    shards = 1 if mesh is None else smagg.mesh_worker_shards(mesh)
    leaves = _worker_leaves(params, axes)
    total = worker_leaf_bytes(params, axes) * shards
    w = int(leaves[0].shape[0]) * shards if leaves else None
    n_dev = mesh.size() if mesh is not None else 1
    records = _load_auto_table(table_path)
    if records is None and table_path not in _MISSING_TABLE_WARNED:
        _MISSING_TABLE_WARNED.add(table_path)
        warnings.warn(
            f"backend='auto': no bench table at {table_path}; falling back "
            f"to the size heuristic", stacklevel=2)
    if records:
        cands = []
        for r in records:
            spec, us = r.get("spec"), r.get("us_per_call")
            if not spec or us is None or r.get("overlap"):
                continue
            try:
                sched_name, _ = resolve_spec(spec)
            except KeyError:
                continue
            if not _spec_runnable(sched_name, mesh, n_pods, w, require_mask):
                continue
            dist = (abs(math.log(max(r.get("total_bytes", 1), 1))
                        - math.log(max(total, 1)))
                    + abs(math.log(max(r.get("mesh_devices", 1), 1))
                          - math.log(max(n_dev, 1))))
            if dist > AUTO_MAX_LOG_DIST:
                continue
            cands.append((dist, float(us), spec))
        if cands:
            nearest = min(c[0] for c in cands)
            return min((c for c in cands if c[0] <= nearest + 1e-9),
                       key=lambda c: c[1])[2]
    if total < (1 << 22):
        return "einsum:f32"
    if mesh is not None and n_dev > 1 \
            and _spec_runnable("rs_ag", mesh, n_pods, w, require_mask):
        return "rs_ag:bf16"
    return "einsum:bf16"
