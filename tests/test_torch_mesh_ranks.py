"""The port's decentralized WASGD across processes: spawned gloo groups of
2 and 4 ranks on the CPU (``torch.distributed``, a ``FileStore`` under
``tmp_path``), over a ``("data",)`` mesh of 2 and 4 and a
``("pod", "data")`` (2, 2) mesh, w 8 workers.

Each test spawns its group once and runs every case in it; the ranks
write what they saw and the test compares it. The multi-rank runs are
held to the port's meshless round (held to JAX by the other port tests):

* one aggregate of every ``schedule:codec`` spec on the same inputs,
  every rank's rows gathered: within the codec's ``error_bound`` of the
  meshless float32 aggregate; the quantizing codecs' payload rows bitwise
  the meshless payload's; a mesh schedule within 1e-6 of the meshless
  ``einsum`` of its codec (bf16: its bound only); a meshless schedule
  under the mesh bitwise its meshless self;
* the MLP through ``Trainer.run`` for 3 rounds per spec (``shard_map:f32``,
  ``rs_ag:{f32,bf16,int8,int4}``, ``async_shard_map``, ``async_rs_ag``
  under a straggler schedule, ``auto``), against the meshless run of the
  same codec: float32 within 1e-6 (relative to the leaf's largest value),
  the others within ``rounds * 2 * error_bound`` of the final leaf (two
  rounding paths, each within the bound, over the rounds);
* on every rank the same h, theta, Judge scores, losses, order seeds,
  measured-time arrivals and active sets;
* the pipelined ``rs_ag`` round bitwise the unpipelined one;
* in the 2 ranks, a ``(data 1, model 2)`` mesh: two replicas, each with
  every worker row, the mesh schedules within 1e-6 of the meshless
  aggregate.

This file imports no JAX in the ranks; the ``auto`` expectations come from
the JAX package's ``select_auto_spec`` in the parent, on a stand-in of a
mesh of the group's size.
"""
import functools
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.func import vmap  # noqa: E402

from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import backends as B  # noqa: E402
from repro_torch.core import shardmap_agg as smagg  # noqa: E402
from repro_torch.core.async_device import run_parallel_sgd_on_device  # noqa: E402
from repro_torch.core.async_sim import StepTimeModel, make_schedule  # noqa: E402
from repro_torch.core.codecs import get_codec  # noqa: E402
from repro_torch.core import shared_axes  # noqa: E402
from repro_torch.data import OrderedDataset, make_classification  # noqa: E402
from repro_torch.models import classification_loss, init_mlp, mlp_apply  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

W, TAU, B_LOCAL, ROUNDS, LR = 8, 2, 4, 3, 0.05
N_ACTIVE = 6                    # Alg. 4: 6 of the 8 workers a round
TABLE = B.AUTO_BENCH_PATH
TRAIN_SPECS = ["shard_map:f32", "rs_ag:f32", "rs_ag:bf16", "rs_ag:int8",
               "rs_ag:int4", "async_shard_map", "async_rs_ag", "auto"]
# float32 elements a worker of the auto-selector's trees: 8 MiB in all
# (near the table's records) and 64 MiB (past them: the size heuristic)
SIZES = {"table": 1 << 18, "large": 1 << 21}
SPAWN_LIMIT_S = 120


def _loss_fn(p, b):
    return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}


def _grad_fn(ps, batch):
    with torch.enable_grad():
        tracked = tree_map(lambda x: x.detach().requires_grad_(), ps)
        losses = vmap(lambda p, b: _loss_fn(p, b)[0])(tracked, batch)
        flat = iter(torch.autograd.grad(losses.sum(), tree_leaves(tracked)))
    return losses.detach(), tree_map(lambda x: next(flat), tracked)


@functools.lru_cache(maxsize=None)
def _data():
    return make_classification(0, 1024, d=16, n_classes=4)


def _schedule():
    return make_schedule(StepTimeModel(W, sigma=0.3, straggle_p=0.2,
                                       straggle_mult=10, seed=3),
                         rounds=ROUNDS, tau=TAU, n_workers=N_ACTIVE,
                         backups=W - N_ACTIVE)


def _codec_of(spec):
    return B.resolve_spec(spec)[1] or "f32"


def _trainer_run(spec, mesh, pipeline=None):
    """The MLP (init seed 0) for ROUNDS rounds; Alg. 4 specs under the
    straggler schedule. Returns the trainer and its dataset."""
    X, y = _data()
    alg4 = spec.startswith("async_")
    params = init_mlp(0, 16, 32, 4, device="cpu")
    tcfg = TrainConfig(learning_rate=LR, wasgd=WASGDConfig(
        tau=TAU, backend=spec,
        async_mode="on_device" if alg4 else "host_sim"))
    tr = Trainer(_loss_fn, params, shared_axes(params), tcfg, W,
                 rule="wasgd+", device="cpu", mesh=mesh, pipeline=pipeline)
    ds = OrderedDataset({"x": X, "y": y}, W, TAU, B_LOCAL, n_segments=2,
                        boundary_delay=4 if pipeline else 0)
    tr.run(ds, ROUNDS, straggler_schedule=_schedule() if alg4 else None)
    return tr, ds


def _full(tree, mesh):
    return {k: smagg.gather_rows(v, mesh) for k, v in tree.items()}


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": (rng.normal(size=(W, 5, 3)) * 2).astype(np.float32),
              "b": rng.normal(size=(W, 17)).astype(np.float32)}
    return params, {"a": ("worker", None, None), "b": ("worker", None)}


def _aggregate_checks(mesh, out):
    """One aggregate of every spec, masked, on the same inputs."""
    params, axes = _tree()
    rng = np.random.default_rng(2)
    theta = torch.as_tensor(rng.dirichlet(np.ones(W)).astype(np.float32))
    active = torch.as_tensor(np.arange(W) % 3 != 1)
    rows = smagg.local_rows(W, mesh)
    full = {k: torch.as_tensor(v) for k, v in params.items()}
    local = {k: v[rows].contiguous() for k, v in full.items()}
    exact = B.get_backend("einsum:f32").aggregate(
        full, axes, theta, 0.9, ctx=B.AggregationContext(active=active))
    for spec in B.available_specs():
        sched, codec = spec.split(":")
        got = B.get_backend(spec).aggregate(
            local, axes, theta, 0.9, ctx=B.AggregationContext(
                mesh=mesh, n_pods=2, active=active))
        got = _full(got, mesh)
        meshed = B._SCHEDULES[sched].needs_mesh
        same = B.get_backend(f"einsum:{codec}" if meshed else spec).aggregate(
            full, axes, theta, 0.9, ctx=B.AggregationContext(
                n_pods=2, active=active))
        c = get_codec(codec)
        ok, detail = True, {}
        for k in full:
            bound = float(c.error_bound(full[k], theta, 0.9))
            err = float((got[k].float() - exact[k]).abs().max())
            dev = float((got[k].float() - same[k].float()).abs().max())
            detail[k] = [err, bound, dev]
            ok &= err <= bound
            if meshed:
                # bf16 rounds in another order on the ring: its bound only
                ok &= codec == "bf16" or dev <= 1e-6
            else:
                ok &= bool(torch.equal(got[k], same[k]))
            if c.quantizing:
                q_mesh = c.encode(local[k], B.AggregationContext(
                    mesh=mesh, leaf_index=3))[0]
                q_full = c.encode(full[k], B.AggregationContext(
                    leaf_index=3))[0]
                ok &= bool(torch.equal(q_mesh, q_full[rows]))
        out["checks"][f"aggregate/{spec}"] = [bool(ok), detail]


def _train_checks(mesh, out):
    for spec in TRAIN_SPECS:
        tr, ds = _trainer_run(spec, mesh)
        if spec == "auto":
            chosen = B.select_auto_spec(tr.state.params, tr.axes, mesh)
            out["auto_in_run"] = chosen
            codec = _codec_of(chosen)
        else:
            codec = _codec_of(spec)
        # the async aliases' codec is f32 (shard_map:f32; rs_ag with
        # the f32 comm_dtype), as is async_einsum's
        ref, _ = _trainer_run("async_einsum" if spec.startswith("async_")
                              else f"einsum:{codec}", None)
        got = _full(tr.state.params, mesh)
        c = get_codec(codec)
        ok, detail = True, {}
        theta = torch.as_tensor(ref.history[-1]["theta"])
        for k, want in ref.state.params.items():
            err = float((got[k] - want).abs().max())
            scale = float(want.abs().max())
            tol = (1e-6 * max(1.0, scale) if codec == "f32" else
                   ROUNDS * 2 * float(c.error_bound(want, theta, 0.9)))
            detail[k] = [err, tol]
            ok &= err <= tol
        out["checks"][f"train/{spec}"] = [bool(ok), detail]
        out["same"][f"train/{spec}"] = {
            key: [np.asarray(h[key]).tolist() for h in tr.history]
            for key in ("h", "theta", "scores", "loss")}
        out["same"][f"seeds/{spec}"] = np.asarray(ds.order.seeds).tolist()
        out["same"][f"losses/{spec}"] = tr.losses().tolist()


def _pipeline_checks(mesh, out):
    plain, _ = _trainer_run("rs_ag:f32", mesh)
    piped, _ = _trainer_run("rs_ag:f32", mesh, pipeline="parity")
    hist_eq = all(np.array_equal(a[k], b[k])
                  for a, b in zip(plain.history, piped.history)
                  for k in ("h", "theta", "scores", "loss", "loss_last"))
    params_eq = all(torch.equal(plain.state.params[k], piped.state.params[k])
                    for k in plain.state.params)
    out["checks"]["pipeline/parity_bitwise"] = [hist_eq and params_eq,
                                                [hist_eq, params_eq]]
    spec, _ = _trainer_run("rs_ag:f32", mesh, pipeline="speculative")
    devs = np.stack([h["spec_dev"] for h in spec.history])
    out["checks"]["pipeline/speculative"] = [
        bool(devs.shape == (ROUNDS, W) and np.isfinite(devs).all()
             and devs[0].max() == 0.0), devs.tolist()]
    out["same"]["speculative/spec_dev"] = devs.tolist()


def _measured_checks(mesh, out):
    X, y = _data()
    rng = np.random.default_rng(0)

    def batches():
        while True:
            idx = rng.integers(0, len(X), size=(W, TAU * B_LOCAL))
            yield {"x": X[idx], "y": y[idx]}

    res = run_parallel_sgd_on_device(
        _grad_fn, init_mlp(0, 16, 32, 4, device="cpu"),
        shared_axes(init_mlp(0, 16, 32, 4, device="cpu")), batches(),
        n_workers=N_ACTIVE, backups=W - N_ACTIVE, tau=TAU, rounds=ROUNDS,
        lr=LR, measure_times=True, policy="ema(0.9)|time_aware",
        backend="async_rs_ag", ctx=B.AggregationContext(mesh=mesh),
        device="cpu")
    times = np.asarray(res.round_times)
    active = [np.sort(np.argsort(t, kind="stable")[:N_ACTIVE]).tolist()
              for t in times]
    per_shard = times.reshape(ROUNDS, smagg.mesh_worker_shards(mesh), -1)
    out["checks"]["measured/shard_times"] = [
        bool((per_shard == per_shard[..., :1]).all()
             and np.isfinite(res.losses).all()), times.tolist()]
    out["same"]["measured/times"] = times.tolist()
    out["same"]["measured/active"] = active
    out["same"]["measured/losses"] = np.asarray(res.losses).tolist()


def _auto_checks(mesh, out, expect):
    params = init_mlp(0, 16, 32, 4, device="cpu")
    rows = smagg.local_rows(W, mesh)
    small = {k: v.unsqueeze(0).expand(W, *v.shape)[rows]
             for k, v in params.items()}
    trees = {"small": small}
    for name, n in SIZES.items():
        trees[name] = {"w": torch.zeros(1).expand(len(range(W)[rows]), n)}
    for name, tree in trees.items():
        axes = shared_axes({k: v[0] for k, v in tree.items()})
        axes = {k: ("worker",) + ax for k, ax in axes.items()}
        for mask in (False, True):
            for table in (TABLE, "missing"):
                key = f"{name}/{mask}/{table != 'missing'}"
                got = B.select_auto_spec(tree, axes, mesh, table_path=table,
                                         require_mask=mask)
                out["checks"][f"auto/{key}"] = [got == expect[key],
                                                [got, expect[key]]]


def _model_axis_check(out):
    """A ("data", "model") mesh with a model axis of 2: each rank is a
    replica holding every worker row, and the mesh schedules give the
    meshless aggregate of their codec within 1e-6."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    params, axes = _tree()
    full = {k: torch.as_tensor(v) for k, v in params.items()}
    theta = torch.as_tensor(np.random.default_rng(4).dirichlet(
        np.ones(W)).astype(np.float32))
    want = B.get_backend("einsum:f32").aggregate(full, axes, theta, 0.9)
    errs = {}
    for spec in ("shard_map:f32", "rs_ag:f32"):
        got = B.get_backend(spec).aggregate(
            full, axes, theta, 0.9, ctx=B.AggregationContext(mesh=mesh))
        errs[spec] = max(float((got[k] - want[k]).abs().max())
                         for k in want)
    out["checks"]["model_axis/replica_aggregate"] = [
        smagg.mesh_worker_shards(mesh) == 1
        and smagg.local_rows(W, mesh) == slice(0, W)
        and max(errs.values()) <= 1e-6, errs]
    out["model_axis_replica"] = smagg.replica_index(mesh)


def _rank_main(rank, world, shape, dims, store, out_dir, expect):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=dims)
        out = {"rank": rank, "checks": {}, "same": {}}
        _aggregate_checks(mesh, out)
        _train_checks(mesh, out)
        _pipeline_checks(mesh, out)
        _measured_checks(mesh, out)
        _auto_checks(mesh, out, expect)
        if dims == ("data",) and world == 2:
            _model_axis_check(out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


class _MeshShape:
    """The two attributes of a JAX ``Mesh`` that ``select_auto_spec``
    reads, for a group of this size."""

    def __init__(self, shape, dims):
        self.shape = dict(zip(dims, shape))
        self.size = int(np.prod(shape))


def _jax_auto_expectations(shape, dims):
    pytest.importorskip("jax")
    from repro.core import backends as jbk
    from repro.models import cnn as jcnn
    import jax
    from repro.models.param import build as jbuild
    params, _ = jbuild(functools.partial(jcnn.mlp_init, d_in=16, d_hidden=32,
                                         n_classes=4), jax.random.key(0))
    small = {k: np.zeros((W,) + tuple(v.shape), np.float32)
             for k, v in params.items()}
    trees = {"small": small}
    for name, n in SIZES.items():
        trees[name] = {"w": np.broadcast_to(np.zeros(1, np.float32), (W, n))}
    mesh = _MeshShape(shape, dims)
    out = {}
    for name, tree in trees.items():
        axes = {k: ("worker",) + (None,) * (v.ndim - 1)
                for k, v in tree.items()}
        for mask in (False, True):
            for table in (TABLE, "missing"):
                out[f"{name}/{mask}/{table != 'missing'}"] = \
                    jbk.select_auto_spec(tree, axes, mesh, table_path=table,
                                         require_mask=mask)
    return out


def _spawn(tmp_path, shape, dims):
    world = int(np.prod(shape))
    expect = _jax_auto_expectations(shape, dims)
    ctx = mp.start_processes(
        _rank_main, args=(world, shape, dims, str(tmp_path / "store"),
                          str(tmp_path), expect),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo group {shape} over {SPAWN_LIMIT_S} s")
    outs = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.json") as f:
            outs.append(json.load(f))
    return outs


def _hold(outs):
    failed = {k: v[1] for k, v in outs[0]["checks"].items() if not v[0]}
    assert not failed, failed
    for o in outs[1:]:
        assert o["checks"].keys() == outs[0]["checks"].keys()
        assert all(v[0] for v in o["checks"].values())
        for k, v in outs[0]["same"].items():
            assert o["same"][k] == v, (o["rank"], k)


@pytest.mark.parametrize("shape, dims", [
    ((2,), ("data",)), ((4,), ("data",)), ((2, 2), ("pod", "data"))],
    ids=["data2", "data4", "pod2xdata2"])
def test_gloo_group_matches_the_meshless_round(tmp_path, shape, dims):
    outs = _spawn(tmp_path, shape, dims)
    _hold(outs)
    if shape == (2,):
        assert "model_axis/replica_aggregate" in outs[0]["checks"]
        assert [o["model_axis_replica"] for o in outs] == [0, 1]
