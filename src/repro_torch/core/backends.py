"""Two-axis aggregation API: collective *schedule* x payload *codec*, the
counterpart of ``repro/core/backends.py``. ``WASGDConfig.backend`` takes

    "<schedule>:<codec>"        e.g. "pallas_wagg:int8", "hierarchical:bf16"

a bare ``"<schedule>"`` (codec from ``ctx.comm_dtype``) or a legacy alias.

Schedules ported (all meshless: one device holds every worker):

``einsum``        the reference: tensordot over the worker axis, then the
                  FMA (``fma_late_join``).
``hierarchical``  pod-local reduce in the codec's reduce dtype, then a
                  float32 cross-pod reduce. Needs ``ctx.n_pods >= 2``
                  dividing the worker count.
``pallas_wagg``   the fused kernel (``kernels/wagg``): codec decode, the
                  Alg. 4 mask and the Eq. 10 FMA in one pass, by the CUDA
                  kernel on a CUDA tensor (its plain version on the CPU).
                  The name is the JAX package's, so configs carry over.

``shard_map``, ``rs_ag`` and ``auto`` (and the aliases that name them)
place collectives on a device mesh and are not ported yet: naming them
raises ``NotImplementedError``.

Every schedule runs ``prepare -> reduce_phase(i) for i < n_phases ->
finalize`` for each worker leaf. Without an ``overlap=`` thunk the
backend takes one leaf through all of that before the next, so one leaf's
reduce state is alive at a time. With a thunk it runs as the JAX package
does: every leaf's prepare and phase 0, then the thunk (between the
``hierarchical`` schedule's two hops; after the one phase of ``einsum``
and ``pallas_wagg``), then the later phases and every finalize. Each
leaf's arithmetic is the same either way, so the params are too; the
thunk's result comes back beside them and never feeds the aggregate.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import dtype_of
from repro_torch.core.aggregate import fma_late_join, is_worker_leaf
from repro_torch.core.codecs import (available_codecs, codec_for_dtype,
                                     get_codec)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class AggregationContext:
    """Knobs every schedule and codec receives.

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
    comm_dtype: torch.dtype = torch.float32
    n_pods: int = 1
    active: Optional[torch.Tensor] = None
    key: Optional[int] = None
    leaf_index: Optional[int] = None


DEFAULT_CONTEXT = AggregationContext()

MESH_NOT_PORTED = ("places collectives on a device mesh and is not ported "
                   "yet (ROADMAP.md queue 1.7)")


class _EinsumSchedule:
    name = "einsum"
    n_phases = 1
    codecs = None

    def prepare(self, x, theta, codec, ctx):
        payload, aux = codec.encode(x, ctx)
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
    n_phases = 2
    codecs = None

    def validate(self, theta, ctx):
        w = theta.shape[0]
        if ctx.n_pods < 2 or w % ctx.n_pods:
            raise ValueError(
                f"'hierarchical' schedule needs ctx.n_pods >= 2 dividing the "
                f"worker count (got n_pods={ctx.n_pods}, workers={w}); set "
                f"WASGDConfig.n_pods or use the 'einsum' schedule")

    def prepare(self, x, theta, codec, ctx):
        payload, aux = codec.encode(x, ctx)
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


class _PallasWaggSchedule:
    """The fused kernel: the codec's payload rides into it as-is (its
    per-leaf scale folded into theta by ``wagg_fused_leaf``) and is widened
    to float32 in the same pass as the mask and the FMA."""
    name = "pallas_wagg"
    n_phases = 1
    codecs = ("f32", "bf16", "int8", "int4")

    def prepare(self, x, theta, codec, ctx):
        if codec.name == "f32":
            return {"payload": None, "aux": None}    # the kernel reads x once
        payload, aux = codec.encode(x, ctx)
        return {"payload": payload, "aux": aux}

    def reduce_phase(self, i, state, theta, codec, ctx):
        return state               # the fused kernel is the reduce

    def finalize(self, state, x, theta, beta, codec, ctx):
        from repro_torch.kernels.wagg.ops import wagg_fused_leaf
        return wagg_fused_leaf(x, state["payload"], state["aux"], theta,
                               beta, active=ctx.active)


_SCHEDULES: Dict[str, object] = {
    s.name: s for s in (_EinsumSchedule(), _HierarchicalSchedule(),
                        _PallasWaggSchedule())}
_COMPOSED: Dict[str, "ComposedBackend"] = {}

# old name -> (schedule, codec or None); None: codec from ctx.comm_dtype
_ALIASES: Dict[str, Tuple[str, Optional[str]]] = {
    "einsum": ("einsum", None),
    "quantized": ("einsum", "int8"),
    "hierarchical": ("hierarchical", None),
    "pallas_wagg": ("pallas_wagg", "f32"),
    "async_einsum": ("einsum", None),
}

_NOT_PORTED = {"shard_map", "rs_ag", "auto", "async_shard_map",
               "async_rs_ag"}


def resolve_spec(name: str) -> Tuple[str, Optional[str]]:
    """``alias | schedule | schedule:codec`` -> (schedule, codec or None).
    Raises ``NotImplementedError`` for what is not ported yet and
    ``KeyError`` with the known names for anything else unresolvable."""
    sched, _, codec = name.partition(":")
    if sched in _NOT_PORTED:
        raise NotImplementedError(f"aggregation spec {name!r}: {sched!r} "
                                  f"{MESH_NOT_PORTED}")
    if name in _ALIASES:
        return _ALIASES[name]
    if codec:
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
        f"{sorted(_ALIASES)}, or compose a '<schedule>:<codec>' spec from "
        f"schedules {sorted(_SCHEDULES)} x codecs {list(available_codecs())}")


class ComposedBackend:
    """schedule x codec: ``aggregate(params, axes, theta, beta, ctx=)``
    applies Eq. 10 to every worker leaf. With ``overlap=`` (a nullary
    thunk, its result any tree) the return value is ``(params,
    overlap_result)`` and the thunk runs after every leaf's phase 0."""

    def __init__(self, schedule, codec_name: Optional[str], name: str):
        self.schedule = schedule
        self.codec_name = codec_name
        self.name = name

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

    def aggregate(self, params: Dict, axes: Dict, theta: torch.Tensor, beta,
                  *, ctx: AggregationContext = DEFAULT_CONTEXT,
                  overlap: Optional[Callable] = None):
        codec = self._codec(ctx)
        sched = self.schedule
        validate = getattr(sched, "validate", None)
        if validate is not None:
            validate(theta, ctx)
        theta = theta.float()
        if overlap is not None:             # phase-major, the thunk between
            run = PhaseMajor(sched, codec, params, axes, theta, ctx)
            run.reduce(0)
            overlap_out = overlap()
            for phase in range(1, sched.n_phases):
                run.reduce(phase)
            return run.finalize(beta), overlap_out
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
        codec = self._codec(ctx)
        validate = getattr(self.schedule, "validate", None)
        if validate is not None:
            validate(theta, ctx)
        return PhaseMajor(self.schedule, codec, params, axes, theta.float(),
                          ctx)


class PhaseMajor:
    """One phase-major aggregate: ``reduce(0)`` prepares every worker leaf
    and runs its first reduce phase, ``reduce(k)`` the later phases leaf
    by leaf, ``finalize(beta)`` the Eq. 10 FMA of every leaf and returns
    the new tree. Every leaf's reduce state is alive between the phases
    (for ``einsum`` a float32 mean of each leaf), which is why the
    aggregate without a thunk goes leaf by leaf instead."""

    def __init__(self, sched, codec, params, axes, theta, ctx):
        self.sched, self.codec, self.theta = sched, codec, theta
        self.params, self.axes = params, axes
        self.ctxs, self.xs = {}, {}
        position = itertools.count()

        def index(x, ax):
            i = next(position)              # the flatten order: sorted keys
            if is_worker_leaf(ax):
                self.ctxs[i] = dataclasses.replace(ctx, leaf_index=i)
                self.xs[i] = x
            return x

        tree_map(index, params, axes)
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
        position = itertools.count()

        def leaf(x, ax):
            i = next(position)
            if not is_worker_leaf(ax):
                return x
            return self.sched.finalize(self.states.pop(i), x, self.theta,
                                       beta, self.codec, self.ctxs[i])

        return tree_map(leaf, self.params, self.axes)


def canonical_spec(name: str) -> str:
    """An alias or spec in ``schedule[:codec]`` form."""
    sched, codec = resolve_spec(name)
    return sched if codec is None else f"{sched}:{codec}"


def get_backend(name: str) -> ComposedBackend:
    if name not in _COMPOSED:
        sched_name, codec_name = resolve_spec(name)
        _COMPOSED[name] = ComposedBackend(_SCHEDULES[sched_name], codec_name,
                                          name)
    return _COMPOSED[name]


def aggregate_with(name: str, params: Dict, axes: Dict, theta: torch.Tensor,
                   beta, *, ctx: AggregationContext = DEFAULT_CONTEXT,
                   overlap: Optional[Callable] = None):
    """``get_backend(name).aggregate(...)``; with ``overlap=`` the return
    value is ``(params, overlap_result)``."""
    return get_backend(name).aggregate(params, axes, theta, beta, ctx=ctx,
                                       overlap=overlap)


def aggregate_from_config(wcfg, params: Dict, axes: Dict,
                          theta: torch.Tensor, *, beta=None,
                          overlap: Optional[Callable] = None):
    """Eq. 10 with the backend and context a ``WASGDConfig`` selects;
    ``beta`` defaults to ``wcfg.beta``; ``overlap`` as in
    ``aggregate_with``."""
    beta = wcfg.beta if beta is None else beta
    return aggregate_with(backend_name_from_config(wcfg), params, axes,
                          theta, beta, ctx=context_from_config(wcfg),
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
        sched = "hierarchical"
    elif wcfg.sharded_aggregate:
        sched = "rs_ag"
    if wcfg.quantize_comm:
        return f"{sched}:int8"
    return sched


def context_from_config(wcfg) -> AggregationContext:
    return AggregationContext(comm_dtype=dtype_of(wcfg.comm_dtype),
                              n_pods=wcfg.n_pods)
