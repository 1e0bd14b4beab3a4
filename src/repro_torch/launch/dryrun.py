"""Dry run of every (architecture x input-shape x mesh) combination, the
counterpart of ``repro/launch/dryrun.py``: the step a combination runs is
traced on ``torch.device("meta")``, where every tensor has a shape and a
dtype and no data, so nothing is allocated, no card is touched and CUDA is
never initialised. The trace counts the step's FLOPs
(``torch.utils.flop_counter.FlopCounterMode``: matrix products,
convolutions and attention; elementwise work is not counted), the bytes
its dispatched operations read and write, and the peak of its live
tensors, and turns them into a three-term roofline for an H100 SXM.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.jsonl

The meshes are JAX's production shapes, {data 16, model 16} (256 cards)
or {pod 2, data 16, model 16} (512), as plain mappings (``MeshShape``).
JAX's ``make_production_mesh`` lays out TPU pods; nothing here places an
array, so it has no counterpart, and neither has the JAX module's
``XLA_FLAGS`` prologue (its 512 forced host devices). ``launch/hlo.py``
has none either: it parses the HLO text that XLA compiles, and a traced
torch program has no HLO. Its collective count comes from the port's own
aggregation spec instead (``worker_collectives``), phase by phase as
``core/shardmap_agg.py`` runs it.

Each record keeps JAX's keys wherever they mean something here:

* ``hlo_flops_per_chip``: the whole program's counted FLOPs / cards;
  ``hlo_bytes_per_chip`` its operations' bytes / cards.
* ``memory.argument_bytes``: one card's bytes of the arguments laid out
  by the rule tables (``parallel/sharding.py``), the number JAX's
  ``memory_analysis().argument_size_in_bytes`` gives.
* ``port_memory``: one card of the port's own layout, as
  ``Trainer(mesh=)`` holds it: the worker rows cut over ``(pod, data)``,
  the ``model`` axis a replica, one-copy experts whole; for serving the
  batch rows cut the same way, the weights whole. ``peak`` is traced on
  that card's program; the six kernels run their plain versions on meta,
  so it counts the plain versions' temporaries, not the kernels'.
* ``collective_bytes``: the worker axis's bytes per round on one card of
  that layout (all-reduce for ``shard_map``, reduce-scatter and
  all-gather for ``rs_ag``, the rows' all-gather for a meshless spec, the
  one-copy experts' gradient all-reduce every local step, the energies'
  and losses' gathers). ``collective_by_axis.model`` is None: the port
  has no tensor parallelism, and JAX's model-axis traffic is what XLA's
  partitioner inserts.
* ``t_trace_s`` (and ``t_trace_card_s``) in place of ``t_lower_s`` and
  ``t_compile_s``.
* ``roofline``: compute, memory and collective seconds. The memory term
  is the bytes every dispatched operation reads and writes, with the
  plain versions standing in for the six kernels: a bound for unfused
  code, above what the fused kernels move.

The traced round has no process group: a spec whose schedule needs a
mesh (``shard_map``, ``rs_ag``) runs as the meshless ``einsum`` of its
codec, the same arithmetic; its collectives are the counted ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from typing import Dict, List, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, InputShape,
                                 TrainConfig, WASGDConfig, dtype_of,
                                 get_config)
from repro_torch.core import backends
from repro_torch.core.aggregate import is_worker_leaf
from repro_torch.core.codecs import codec_for_dtype, get_codec
from repro_torch.launch.specs import input_specs
from repro_torch.parallel.sharding import (TRAIN_RULES, MeshShape,
                                           leaves_with_axes, num_workers,
                                           tree_bytes)

# -- H100 SXM5 hardware model (per card) --------------------------------------
# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: BF16 tensor core
# 1,979 TFLOPS with sparsity, so 989 dense; HBM3 3.35 TB/s; NVLink 900 GB/s
# (both directions together).
PEAK_FLOPS = 989e12           # bf16 dense FLOP/s
HBM_BW = 3.35e12              # bytes/s
NVLINK_BW = 450e9             # bytes/s each way, within a host
# NVIDIA DGX H100 user guide: eight H100 a host and eight single-port
# ConnectX-7 400 Gb/s adapters for the compute fabric, one a card: an
# axis whose group spans hosts moves 50e9 bytes/s each way a card.
NET_BW = 50e9                 # bytes/s each way, across hosts
CARDS_PER_HOST = 8

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def model_flops(cfg, shape, tau: int = 4) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens/step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch        # decode: 1 token/seq


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """JAX's production mesh shape: 256 or 512 cards, ``model`` minor."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def axis_rate(mesh: MeshShape, axes) -> float:
    """Bytes/s each way a card over the group of ``axes``: NVLink if the
    group of card 0 lies in one host (cards numbered row-major over the
    mesh, ``CARDS_PER_HOST`` a host), else the network."""
    names = list(mesh.shape)
    sizes = [mesh.shape[n] for n in names]
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    cards = [0]
    for a in axes:
        if a in mesh.shape:
            i = names.index(a)
            cards = [c + k * strides[i] for c in cards
                     for k in range(sizes[i])]
    hosts = {c // CARDS_PER_HOST for c in cards}
    return NVLINK_BW if len(hosts) == 1 else NET_BW


# -- tracing ------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts the dispatched operations, the bytes they read and write (a
    view moves none) and the peak of the live storages. ``args`` are live
    from the start: their storages count until the traced step drops its
    last reference to them (a round consumes its state). A storage counts
    once, whichever views of it are alive, and leaves the count when it is
    freed (a ``weakref.finalize`` on it)."""

    def __init__(self, args=()):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if not func.is_view:
            ins = tree_flatten((args, kwargs))[0]
            self.bytes += sum(_nbytes(t) for t in ins
                              if isinstance(t, torch.Tensor))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                if not func.is_view:
                    self.bytes += _nbytes(t)
                self._track(t)
        return out


def trace(wl) -> Dict:
    """Runs ``wl.fn`` on its meta arguments under the counters; the
    workload's argument trees are consumed (a round replaces its state's
    leaves), so build one per trace."""
    t0 = time.time()
    with FlopCounterMode(display=False) as fc, \
            TraceCounter(wl.arg_shapes) as tc:
        out = wl.fn(*wl.arg_shapes)
        del out
    return {"flops": float(fc.get_total_flops()), "bytes": float(tc.bytes),
            "ops": tc.ops, "peak": tc.peak, "t": time.time() - t0}


# -- the port's worker-axis collectives -------------------------------------

class _MeshStandIn:
    """What ``core.backends.select_auto_spec`` reads of a ``DeviceMesh``
    (its names, its shape, its size), for the ``auto`` pick of a card of
    the port's layout."""

    def __init__(self, shape: Dict[str, int]):
        self.mesh_dim_names = tuple(shape)
        self.mesh = torch.empty(tuple(shape.values()), device="meta")

    def size(self) -> int:
        return self.mesh.numel()


def _trace_spec(name: str) -> str:
    """The spec the meshless trace runs: a schedule that needs a mesh
    runs as ``einsum`` with the same codec."""
    if name == "auto":
        return name
    codec = backends.resolve_spec(name)[1]
    if backends.get_backend(name).schedule.needs_mesh:
        return "einsum" if codec is None else f"einsum:{codec}"
    return name


def _no_collectives() -> Dict:
    return {"by_kind": {k: 0 for k in COLLECTIVES},
            "counts": {k: 0 for k in COLLECTIVES}, "per_step": 0,
            "spec": None}


def worker_collectives(wcfg: WASGDConfig, params: Dict, axes: Dict,
                       port_mesh: Dict[str, int]) -> Dict:
    """One card's worker-axis collectives in one round of the port's
    layout (``port_mesh``: the worker axes and, if any, ``model``):
    ``{"by_kind", "counts", "per_step"}``, bytes as the operands of each
    collective (JAX's count of the HLO). ``params``/``axes``: the card's
    state (its worker rows, the one-copy leaves whole)."""
    out = _no_collectives()

    def add(kind, nbytes, n=1):
        out["by_kind"][kind] += nbytes
        out["counts"][kind] += n

    shards = math.prod(v for k, v in port_mesh.items() if k != "model")
    if shards == 1:
        return out
    tau = wcfg.tau
    pairs = leaves_with_axes(params, axes)
    worker = [x for x, ax in pairs if is_worker_leaf(ax)]
    shared = [x for x, ax in pairs if not is_worker_leaf(ax)]
    n_local = worker[0].shape[0] if worker else 1
    name = backends.backend_name_from_config(wcfg)
    if name == "auto":
        name = backends.select_auto_spec(
            params, axes, _MeshStandIn(port_mesh), n_pods=wcfg.n_pods,
            require_mask=wcfg.async_mode == "on_device")
    out["spec"] = name
    sched, codec_name = backends.resolve_spec(name)
    needs_mesh = backends.get_backend(name).schedule.needs_mesh
    codec = (get_codec(codec_name) if codec_name
             else codec_for_dtype(dtype_of(wcfg.comm_dtype)))
    # the energies' and the tau steps' losses' gathers
    add("all-gather", 4 * n_local + 4 * n_local * tau, 2)
    for g in shared:               # one-copy leaves: the gradient, each step
        add("all-reduce", tau * _nbytes(g), tau)
        out["per_step"] += _nbytes(g)
    for x in worker:
        n = x[0].numel()
        if not needs_mesh:                      # the rows gathered first
            add("all-gather", _nbytes(x))
            continue
        if codec.quantizing:                    # the leaf's max, int4's key
            add("all-reduce", x.element_size())
            if codec.name == "int4":
                add("all-reduce", 8)
        if sched == "shard_map":
            add("all-reduce", n * codec.reduce_dtype.itemsize)
        else:                                   # rs_ag
            wire = (codec.reduce_dtype if codec.quantizing
                    else codec.wire_dtype).itemsize
            n_pad = n + (-n) % shards
            add("reduce-scatter", n_pad * wire)
            add("all-gather", n_pad // shards * wire)
    return out


# -- one combination ----------------------------------------------------------

def _card_shape(shape: InputShape, shards: int) -> InputShape:
    """The port's card: the batch rows cut over the worker shards (whole
    where they do not divide)."""
    if shards == 1 or shape.global_batch % shards:
        return shape
    return dataclasses.replace(shape,
                               global_batch=shape.global_batch // shards)


def run_one(arch: str, shape_name: Union[str, InputShape], multi_pod: bool,
            tcfg: Optional[TrainConfig] = None, verbose: bool = True,
            unroll: bool = True, cfg_overrides: Optional[Dict] = None,
            variant: str = "baseline", dp_workers: bool = False, *,
            mesh: Optional[MeshShape] = None,
            workers: Optional[int] = None) -> Dict:
    """The record of one combination. ``shape_name`` is a name of
    ``INPUT_SHAPES`` or an ``InputShape``; ``mesh`` replaces the
    production mesh and ``workers`` its worker count (``chip_smoke.py``'s
    one-card round)."""
    shape = (SHAPES_BY_NAME[shape_name] if isinstance(shape_name, str)
             else shape_name)
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    mesh_name = "x".join(str(v) for v in mesh.shape.values())
    n_chips = mesh.size
    n_work = num_workers(mesh) if workers is None else workers
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    tcfg = tcfg or TrainConfig()
    wcfg = tcfg.wasgd

    train_rules = None
    port_mesh = {k: v for k, v in mesh.shape.items() if k in ("pod", "data")}
    if dp_workers:
        # small-model layout: every card is a WASGD worker (the worker axis
        # spans the WHOLE mesh incl. "model"); no tensor parallelism
        train_rules = {**TRAIN_RULES, "worker": ("pod", "data", "model"),
                       "heads": None, "kv_heads": None, "ffn": None,
                       "vocab": None, "expert_ffn": None, "experts": None}
        n_work = n_chips if workers is None else workers
        port_mesh = {"data": n_chips}
    elif "model" in mesh.shape:
        port_mesh["model"] = mesh.shape["model"]
    shards = math.prod(v for k, v in port_mesh.items() if k != "model")
    trace_tcfg = dataclasses.replace(tcfg, wasgd=dataclasses.replace(
        wcfg, backend=_trace_spec(backends.backend_name_from_config(wcfg))))

    def specs(n, shp):
        return input_specs(cfg, shp, n, trace_tcfg, for_dryrun=unroll,
                           train_rules=train_rules)

    wl = specs(n_work, shape)
    window_override = wl.cfg.attn_window != cfg.attn_window
    arg_bytes = sum(tree_bytes(s, a, mesh, wl.rules)
                    for s, a in zip(wl.arg_shapes, wl.arg_axes))
    whole = trace(wl)
    del wl

    train = shape.kind == "train"
    card_shape = _card_shape(shape, shards)
    card_workers = n_work // shards if train else n_work
    if train and n_work % shards:
        raise ValueError(f"{n_work} workers do not split over {shards} "
                         f"worker shards")
    card_wl = specs(card_workers, card_shape)
    per_arg = [tree_bytes(s, a) for s, a in zip(card_wl.arg_shapes,
                                                card_wl.arg_axes)]
    coll = _no_collectives()
    if train:
        state, axes = card_wl.arg_shapes[0], card_wl.arg_axes[0]
        coll = worker_collectives(wcfg, state.params, axes.params,
                                  port_mesh)
        del state, axes
    if shards == 1 and card_shape == shape and card_workers == n_work:
        card, t_card = whole, 0.0            # the card runs the whole program
        del card_wl
    else:
        card = trace(card_wl)
        t_card = card["t"]
        del card_wl

    per_chip_flops = whole["flops"] / n_chips
    bytes_per_chip = whole["bytes"] / n_chips
    mf = model_flops(cfg, shape, wcfg.tau)
    coll_total = sum(coll["by_kind"].values())
    rate = axis_rate(mesh, ("pod", "data", "model") if dp_workers
                     else ("pod", "data"))
    compute_s = per_chip_flops / PEAK_FLOPS
    memory_s = bytes_per_chip / HBM_BW
    collective_s = coll_total / rate
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    # WASGD amortization: the aggregation runs once per tau local steps;
    # the one-copy experts' gradient all-reduce runs every step
    per_step = coll["per_step"]
    agg_bytes = coll_total - wcfg.tau * per_step
    amortized = {f"collective_s_tau{t}": (agg_bytes / t + per_step) / rate
                 for t in (1, 10, 100, 1000)}

    rec = {
        "arch": arch,
        "variant": variant,
        "shape": shape.name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "workers": n_work,
        "chips": n_chips,
        "ok": True,
        "t_trace_s": round(whole["t"], 1),
        "t_trace_card_s": round(t_card, 1),
        "hlo_flops_per_chip": per_chip_flops,
        "hlo_bytes_per_chip": bytes_per_chip,
        "dispatched_ops": whole["ops"],
        "collective_bytes": {**coll["by_kind"], "total": coll_total},
        "collective_counts": coll["counts"],
        "collective_by_axis": {"worker": coll_total, "model": None},
        "collective_amortized": amortized,
        "collective_spec": coll["spec"],
        "model_flops": mf,
        "useful_flops_frac": mf / n_chips / max(per_chip_flops, 1.0),
        "roofline": {**terms, "dominant": dominant,
                     "collective_rate": rate},
        "memory": {"argument_bytes": arg_bytes},
        "port_memory": {
            "layout": {"worker_shards": shards,
                       "replicas": port_mesh.get("model", 1),
                       "workers_per_card": card_workers if train else None,
                       "batch_per_card": card_shape.global_batch},
            "per_argument": per_arg,
            "arguments": sum(per_arg),
            "peak": card["peak"],
            "peak_of": "plain versions' temporaries (meta trace)",
        },
        "window_override": window_override,
    }
    if verbose:
        print(f"[{arch} x {shape.name} x {mesh_name}] OK "
              f"trace={whole['t']:.0f}s+{t_card:.0f}s "
              f"compute={compute_s*1e3:.2f}ms mem={memory_s*1e3:.2f}ms "
              f"coll={collective_s*1e3:.2f}ms dominant={dominant} "
              f"useful={rec['useful_flops_frac']:.2f}")
        print(f"   args/card={arg_bytes} port args={sum(per_arg)} "
              f"port peak={card['peak']}")
    return rec


# -- command line -------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--variant", default="baseline",
                    help="label recorded with each result row")
    ap.add_argument("--sharded-ce", action="store_true")
    ap.add_argument("--windowed-qblock", action="store_true")
    ap.add_argument("--comm-dtype", default="float32")
    ap.add_argument("--backend", default="",
                    help="aggregation spec '<schedule>:<codec>' (e.g. "
                         "'rs_ag:int8'), a legacy alias, or 'auto'; empty "
                         "composes it from the legacy boolean flags "
                         "(core/backends.py)")
    ap.add_argument("--policy", default="",
                    help="worker-assessment policy spec (core/weights.py), "
                         "e.g. 'ema(0.9)|time_aware'; stateful policy state "
                         "rides comm_state into the round")
    ap.add_argument("--expert-sharding", default=None,
                    choices=["ep_data", "worker"])
    ap.add_argument("--dp-workers", action="store_true",
                    help="worker axis spans the whole mesh (no TP)")
    ap.add_argument("--hierarchical", action="store_true")
    ap.add_argument("--async-mode", default="host_sim",
                    choices=["host_sim", "on_device"],
                    help="on_device: trace the Alg. 4 masked round (the "
                         "straggler mask is a (w,) bool input riding in "
                         "comm_state) instead of the synchronous Alg. 1 "
                         "round")
    ap.add_argument("--no-unroll", action="store_true",
                    help="recorded in the config only: the port's "
                         "attention loop runs in Python and every block is "
                         "traced either way")
    ap.add_argument("--tau", type=int, default=1,
                    help="local steps per traced round")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    archs = list(ARCH_IDS) if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES_BY_NAME) \
        if (args.all or args.shape in (None, "all")) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    tcfg = TrainConfig(wasgd=WASGDConfig(
        tau=args.tau, comm_dtype=args.comm_dtype, backend=args.backend,
        policy=args.policy,
        hierarchical=args.hierarchical, n_pods=2 if args.hierarchical else 1,
        async_mode=args.async_mode))
    cfg_overrides = {}
    if args.sharded_ce:
        cfg_overrides["sharded_ce"] = True
    if args.windowed_qblock:
        cfg_overrides["windowed_qblock"] = True
    if args.expert_sharding:
        cfg_overrides["expert_sharding"] = args.expert_sharding

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape, mp, tcfg,
                                  unroll=not args.no_unroll,
                                  cfg_overrides=cfg_overrides,
                                  variant=args.variant,
                                  dp_workers=args.dp_workers)
                except Exception as e:           # noqa: BLE001 — report, keep going
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[{arch} x {shape} x {rec['mesh']}] FAIL: "
                          f"{rec['error']}")
                print(json.dumps(rec))
                results.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} combinations traced")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
