"""The port's mesh schedules (``repro_torch.core.shardmap_agg``, the
``shard_map``/``rs_ag`` specs, ``auto`` and the registry API) against the
JAX package on a one-device mesh, as ``tests/test_backends.py`` builds
it: the port runs in an in-process gloo group of one rank (a
``FileStore`` under ``tmp_path``, created and destroyed by the ``mesh1``
fixture), JAX's ``shard_map`` on ``Mesh(jax.devices()[:1], ("data",))``.
Groups of 2 and 4 ranks are ``tests/test_torch_mesh_ranks.py``'s.

Tolerances. Float32 aggregates: 1e-6 relative to the leaf's largest value
(the all-reduce sums the worker rows in its own order). bf16 specs: the
codec's ``error_bound`` (both packages round bfloat16 sums). int8: 1e-6
(the same codes: both round half to even). int4: twice the codec's
``error_bound``, since JAX draws its noise from threefry and the port from
its counter hash (``tests/test_torch_int4.py``); the phase functions are
fed one payload, so they are held at 1e-6 for every codec. Trainer rounds:
``tests/test_torch_train.py``'s MLP tolerances (params atol 1e-5, h and
loss rtol 1e-5, theta atol 1e-6); with int8, the params within twice the
codec's bound a round.
"""
import contextlib
import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import common  # noqa: E402
from repro import configs as jcfg  # noqa: E402
from repro.core import async_device as jad  # noqa: E402
from repro.core import backends as jbk  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import shardmap_agg as jsm  # noqa: E402
from repro.core import wasgd as jwasgd  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.core import async_device as tad  # noqa: E402
from repro_torch.core import backends as tbk  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import membership as tmem  # noqa: E402
from repro_torch.core import shardmap_agg as tsm  # noqa: E402
from repro_torch.core import wasgd as twasgd  # noqa: E402
from repro_torch.data import OrderedDataset  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

W = 4
BETA = 0.9


@contextlib.contextmanager
def world1(store_path, dims=("data",)):
    """A one-rank gloo group and a mesh of size 1 over ``dims``; the
    group is destroyed on exit (process-group state is global)."""
    dist.init_process_group("gloo", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,) * len(dims), mesh_dim_names=dims)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def mesh1(tmp_path):
    with world1(tmp_path / "store") as mesh:
        yield mesh


def jmesh1():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree(seed=0):
    """The JAX backend tests' layout: a (w, 6, 5) leaf, an odd 33-wide
    one, and a shared leaf without the worker axis."""
    rng = np.random.default_rng(seed)
    params = {"blk": {"w": rng.normal(size=(W, 6, 5)).astype(np.float32)},
              "head": rng.normal(size=(W, 33)).astype(np.float32),
              "experts": {"up": np.ones((3, 2), np.float32)}}
    axes = {"blk": {"w": ("worker", None, None)},
            "head": ("worker", None),
            "experts": {"up": ("experts", None)}}
    theta = rng.dirichlet(np.ones(W)).astype(np.float32)
    return params, axes, theta


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [x for k in sorted(tree) for x in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _f32_tol(x):
    return 1e-6 * max(1.0, float(np.abs(x).max()))


def _hold(ours, ref, xs, codec, theta):
    for o, r, x in zip(_leaves(ours), _leaves(ref), _leaves(xs)):
        if codec in ("f32", "int8"):
            tol = _f32_tol(x)
        else:
            bound = float(jcodecs.get_codec(codec).error_bound(
                jnp.asarray(x), jnp.asarray(theta), BETA))
            tol = bound * (2 if codec == "int4" else 1)
        np.testing.assert_allclose(_np(o), np.asarray(r, np.float32), rtol=0,
                                   atol=tol)


# ---------------------------------------------------------------------------
# Phase functions and flatten_pad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["f32", "bf16", "int8", "int4"])
def test_phase_functions_match_jax(codec, mesh1):
    """Each phase on the same payload (the port's encode of the leaf, so
    int4 rides the same codes): the all-reduce in the codec's reduce
    dtype, the reduce-scatter with the partial in its wire (dtype codecs)
    or reduce dtype (quantizing), the all-gather. w 4 on one shard is the
    w/S > 1 case of tests/test_backends.py:271."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(W, 7, 5)).astype(np.float32)
    theta = rng.dirichlet(np.ones(W)).astype(np.float32)
    c = tcodecs.get_codec(codec)
    payload = c.encode(_t(x), tbk.AggregationContext(mesh=mesh1))[0]
    jpay = jnp.asarray(payload.float().numpy()).astype(
        {"f32": jnp.float32, "bf16": jnp.bfloat16}.get(codec, jnp.int8))
    rd_t, rd_j = c.reduce_dtype, jcodecs.get_codec(codec).reduce_dtype
    ours = tsm.all_reduce_m_phase(payload, _t(theta), mesh1, rd_t)
    ref = jsm.all_reduce_m_phase(jpay, jnp.asarray(theta), jmesh1(), rd_j)
    tol = _f32_tol(x) * (1 if codec == "f32" else 100)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=0,
                               atol=tol if codec != "bf16" else 2e-2)
    wire_t = rd_t if c.quantizing else c.wire_dtype
    wire_j = rd_j if c.quantizing else jcodecs.get_codec(codec).wire_dtype
    flat_t, n_t = tsm.flatten_pad(payload, 1)
    flat_j, n_j = jsm.flatten_pad(jpay, 1)
    assert n_t == n_j == 35
    scat = tsm.reduce_scatter_phase(flat_t, _t(theta), mesh1, wire_t)
    jscat = jsm.reduce_scatter_phase(flat_j, jnp.asarray(theta), jmesh1(),
                                     wire_j)
    assert scat.dtype == {jnp.float32: torch.float32,
                          jnp.bfloat16: torch.bfloat16}[jnp.dtype(
                              jscat.dtype).type]
    np.testing.assert_array_equal(_np(scat), np.asarray(jscat, np.float32))
    m, work = tsm.reduce_scatter_phase(flat_t, _t(theta), mesh1, wire_t,
                                       async_op=True)
    gathered = tsm.all_gather_phase(m, mesh1, work=work)
    np.testing.assert_array_equal(
        _np(gathered), np.asarray(jsm.all_gather_phase(jscat, jmesh1())))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_flatten_pad_matches_jax(p):
    x = np.arange(4 * 33, dtype=np.float32).reshape(4, 3, 11)
    ours, n = tsm.flatten_pad(_t(x), p)
    ref, nj = jsm.flatten_pad(jnp.asarray(x), p)
    assert n == nj == 33
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Every schedule:codec spec through get_backend(spec).aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("spec", tbk.available_specs())
def test_specs_match_jax_on_one_device_mesh(spec, masked, mesh1):
    params, axes, theta = _tree()
    act = np.array([True, False, True, True]) if masked else None
    ctx_t = tbk.AggregationContext(mesh=mesh1, n_pods=2, active=None
                                   if act is None else _t(act))
    ctx_j = jbk.AggregationContext(mesh=jmesh1(), n_pods=2, active=None
                                   if act is None else jnp.asarray(act))
    ours = tbk.get_backend(spec).aggregate(_tmap(_t, params), axes,
                                           _t(theta), BETA, ctx=ctx_t)
    ref = jbk.get_backend(spec).aggregate(_tmap(jnp.asarray, params), axes,
                                          jnp.asarray(theta), BETA, ctx=ctx_j)
    _hold(ours, ref, params, spec.split(":")[1], theta)
    np.testing.assert_array_equal(_np(ours["experts"]["up"]),
                                  params["experts"]["up"])


def test_available_specs_are_jaxs():
    assert tbk.available_specs() == jbk.available_specs()
    assert tbk.available_schedules() == jbk.available_schedules()
    assert tbk.available_backends() == jbk.available_backends()


@pytest.mark.parametrize("schedule", ["all_reduce", "rs_ag"])
@pytest.mark.parametrize("comm", ["float32", "bfloat16"])
def test_fused_entries_match_jax(schedule, comm, mesh1):
    """weighted_aggregate_shard_map (and through it the per-leaf fused
    entries), w 4 on one shard, the 33-wide leaf unpadded."""
    params, axes, theta = _tree(1)
    ours = tsm.weighted_aggregate_shard_map(
        _tmap(_t, params), axes, _t(theta), BETA, mesh1, schedule=schedule,
        comm_dtype=getattr(torch, comm))
    ref = jsm.weighted_aggregate_shard_map(
        _tmap(jnp.asarray, params), axes, jnp.asarray(theta), BETA,
        jmesh1(), schedule=schedule, comm_dtype=getattr(jnp, comm))
    codec = "f32" if schedule == "all_reduce" or comm == "float32" \
        else "bf16"
    _hold(ours, ref, params, codec, theta)
    act = np.array([False, True, True, False])
    x = params["head"]
    for fn_t, fn_j in ((tsm.aggregate_leaf_shard_map,
                        jsm.aggregate_leaf_shard_map),
                       (tsm.aggregate_leaf_rs_ag, jsm.aggregate_leaf_rs_ag)):
        o = fn_t(_t(x), _t(theta), BETA, mesh1, active=_t(act))
        r = fn_j(jnp.asarray(x), jnp.asarray(theta), BETA, jmesh1(),
                 active=jnp.asarray(act))
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0,
                                   atol=_f32_tol(x))


# ---------------------------------------------------------------------------
# Without a mesh, JAX's errors; the legacy and compat entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["shard_map", "rs_ag:int8",
                                  "async_shard_map", "async_rs_ag"])
def test_mesh_specs_need_a_mesh_like_jax(spec):
    params, axes, theta = _tree()
    for bk, tree, th in ((tbk, _tmap(_t, params), _t(theta)),
                         (jbk, _tmap(jnp.asarray, params),
                          jnp.asarray(theta))):
        with pytest.raises(ValueError, match="needs ctx.mesh"):
            bk.get_backend(spec).aggregate(tree, axes, th, BETA)
    for step in (tstep, jstep):
        cfg = (tcfg if step is tstep else jcfg).WASGDConfig(backend=spec)
        with pytest.raises(ValueError, match="needs a mesh"):
            step.wasgd_rule(cfg)
        with pytest.raises(ValueError, match="needs a mesh"):
            step.async_wasgd_rule(dataclasses.replace(
                cfg, async_mode="on_device"))


@pytest.mark.parametrize("kw", [{"sharded_aggregate": True},
                                {"sharded_aggregate": True,
                                 "quantize_comm": True}])
def test_legacy_sharded_aggregate_runs_under_a_mesh(kw, mesh1):
    """``WASGDConfig(sharded_aggregate=True)`` resolves to rs_ag: it
    raises without a mesh and runs under one, as JAX's does."""
    params, axes, theta = _tree()
    h = np.array([1.2, 0.7, 2.0, 1.1], np.float32)
    wt, wj = tcfg.WASGDConfig(**kw), jcfg.WASGDConfig(**kw)
    with pytest.raises(ValueError, match="needs ctx.mesh"):
        twasgd.communicate(_tmap(_t, params), axes, _t(h), wt)
    with pytest.raises(ValueError, match="needs ctx.mesh"):
        jwasgd.communicate(_tmap(jnp.asarray, params), axes, jnp.asarray(h),
                           wj)
    ours = twasgd.communicate(_tmap(_t, params), axes, _t(h), wt, mesh=mesh1)
    ref = jwasgd.communicate(_tmap(jnp.asarray, params), axes,
                             jnp.asarray(h), wj, mesh=jmesh1())
    np.testing.assert_allclose(_np(ours.theta), np.asarray(ref.theta),
                               atol=1e-6)
    _hold(ours.params, ref.params, params,
          "int8" if kw.get("quantize_comm") else "f32", np.asarray(ref.theta))


@pytest.mark.parametrize("schedule", ["all_reduce", "rs_ag"])
def test_weighted_aggregate_async_under_a_mesh(schedule, mesh1):
    params, axes, theta = _tree(4)
    act = np.array([True, True, False, True])
    theta = np.where(act, theta, 0).astype(np.float32)
    theta /= theta.sum()
    ours = tad.weighted_aggregate_async(
        _tmap(_t, params), axes, _t(theta), _t(act), BETA, mesh=mesh1,
        schedule=schedule)
    ref = jad.weighted_aggregate_async(
        _tmap(jnp.asarray, params), axes, jnp.asarray(theta),
        jnp.asarray(act), BETA, mesh=jmesh1(), schedule=schedule)
    _hold(ours, ref, params, "f32", theta)


# ---------------------------------------------------------------------------
# The registry API
# ---------------------------------------------------------------------------

class _MeanOfTwo:
    """A custom schedule, written once for each package: the aggregate is
    the theta-weighted sum of the first two workers only."""
    name = "first_two"
    needs_mesh = False
    n_phases = 1
    codecs = ("f32",)
    supports_mask = True

    def __init__(self, xp, fma):
        self.xp, self.fma = xp, fma

    def prepare(self, x, theta, codec, ctx):
        return {"x": x}

    def reduce_phase(self, i, state, theta, codec, ctx):
        x = state["x"]
        return {"m": theta[0] * x[0] + theta[1] * x[1]}

    def finalize(self, state, x, theta, beta, codec, ctx):
        return self.fma(x, state["m"], beta, ctx.active)


def _custom_backend(params, axes, theta, beta, ctx):
    """A monolithic backend for either package: every worker leaf
    scaled by beta."""
    def visit(x, ax):
        if isinstance(ax, dict):
            return {k: visit(x[k], ax[k]) for k in x}
        return x * beta if ax and ax[0] == "worker" else x
    return visit(params, axes)


@contextlib.contextmanager
def _registered(bk, schedule, backend_name):
    bk.register_schedule(schedule)
    bk.register_backend(backend_name, _custom_backend)
    try:
        yield
    finally:
        bk._SCHEDULES.pop(schedule.name, None)
        bk._REGISTRY.pop(backend_name, None)
        bk._COMPOSED.clear()


def test_custom_schedule_and_backend_register_like_jax():
    from repro.core.aggregate import fma_late_join as jfma
    from repro_torch.core.aggregate import fma_late_join as tfma
    params, axes, theta = _tree(2)
    with _registered(tbk, _MeanOfTwo(torch, tfma), "scaled"), \
            _registered(jbk, _MeanOfTwo(jnp, jfma), "scaled"):
        custom = f"{_MeanOfTwo.name}:f32"     # registered for this test
        assert tbk.available_specs() == jbk.available_specs()
        assert custom in tbk.available_specs()
        assert tbk.available_backends() == jbk.available_backends()
        for name in (custom, "scaled"):
            ours = tbk.aggregate_with(name, _tmap(_t, params), axes,
                                      _t(theta), BETA)
            ref = jbk.aggregate_with(name, _tmap(jnp.asarray, params), axes,
                                     jnp.asarray(theta), BETA)
            _hold(ours, ref, params, "f32", theta)
        out, thunk = tbk.aggregate_with("scaled", _tmap(_t, params), axes,
                                        _t(theta), BETA, overlap=lambda: 7)
        assert thunk == 7
        for bk in (tbk, jbk):
            with pytest.raises(ValueError, match="already registered"):
                bk.register_schedule(_MeanOfTwo(None, None))
            with pytest.raises(ValueError, match="already registered"):
                bk.register_backend("scaled", _custom_backend)
            with pytest.raises(ValueError, match="already registered"):
                bk.register_backend("einsum", _custom_backend)
            bk.register_schedule(_MeanOfTwo(None, None), overwrite=True)
            bk.register_backend("scaled", _custom_backend, overwrite=True)
            bk.register_backend("mesh_only", _custom_backend,
                                needs_mesh=True)
            with pytest.raises(ValueError, match="needs ctx.mesh"):
                bk.get_backend("mesh_only").aggregate(
                    {}, {}, None, BETA)
            bk._REGISTRY.pop("mesh_only")
    assert "first_two" not in tbk.available_schedules()


# ---------------------------------------------------------------------------
# backend="auto"
# ---------------------------------------------------------------------------

def _auto_trees():
    """An MLP-sized tree, one near the table's 8 MiB records, one past
    them (broadcast views: no memory)."""
    small = {"a": np.zeros((W, 64, 32), np.float32),
             "b": np.zeros((W, 32), np.float32)}
    near = {"w": np.broadcast_to(np.zeros(1, np.float32), (W, 1 << 19))}
    large = {"w": np.broadcast_to(np.zeros(1, np.float32), (W, 1 << 26))}
    for tree in (small, near, large):
        axes = {k: ("worker",) + (None,) * (v.ndim - 1)
                for k, v in tree.items()}
        yield tree, axes


def _port_tree(tree):
    return {k: torch.zeros(1).expand(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("table", ["repo", "none"])
def test_select_auto_spec_is_jaxs_at_mesh_size_1(table, mesh1, tmp_path):
    path = jbk.AUTO_BENCH_PATH if table == "repo" \
        else str(tmp_path / "no_table.json")
    assert tbk.AUTO_BENCH_PATH == jbk.AUTO_BENCH_PATH
    picked = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for tree, axes in _auto_trees():
            for with_mesh in (False, True):
                for mask in (False, True):
                    for n_pods in (1, 2):
                        ours = tbk.select_auto_spec(
                            _port_tree(tree), axes,
                            mesh1 if with_mesh else None, table_path=path,
                            n_pods=n_pods, require_mask=mask)
                        ref = jbk.select_auto_spec(
                            tree, axes, jmesh1() if with_mesh else None,
                            table_path=path, n_pods=n_pods,
                            require_mask=mask)
                        assert ours == ref, (tree.keys(), with_mesh, mask)
                        picked.append(ours)
    assert len(set(picked)) > 1, picked
    assert tbk.worker_leaf_bytes(*next(iter(
        [(_port_tree(t), a) for t, a in _auto_trees()]))) == \
        jbk.worker_leaf_bytes(*next(_auto_trees()))


def test_auto_warns_once_for_a_missing_table(tmp_path):
    tree, axes = next(_auto_trees())
    path = str(tmp_path / "absent.json")
    with pytest.warns(UserWarning, match="no bench table"):
        tbk.select_auto_spec(_port_tree(tree), axes, table_path=path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tbk.select_auto_spec(_port_tree(tree), axes, table_path=path)
    with pytest.raises(KeyError, match="resolved per parameter tree"):
        tbk.get_backend("auto")


# ---------------------------------------------------------------------------
# The Trainer on a one-rank mesh against JAX's on a one-device mesh
# ---------------------------------------------------------------------------

P, TAU, B_LOCAL, N_SAMPLES, ROUNDS = 4, 8, 8, 512, 4


def _harness_run(framework, spec, mesh, pipeline=None, async_mode=None):
    params_j, axes, loss_j, _ = common.model(0, False)
    X, y = common.dataset(0, False)
    data = {"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}
    wkw = dict(tau=TAU, beta=BETA, backend=spec,
               async_mode=async_mode or "host_sim")
    # pipelined: segment 0's OrderGen decision, due 8 rounds after its
    # end (round 12), lies past any round the prefetchers' run-ahead
    # can generate in 4 rounds, so both packages' seeds are settled
    delay = 8 if pipeline else 0
    sched = None
    if async_mode:
        sched = np.ones((ROUNDS, P), bool)
        sched[1, 2] = sched[2, 0] = sched[3, 3] = False
    if framework == "jax":
        tr = JTrainer(loss_j, params_j, axes,
                      jcfg.TrainConfig(learning_rate=0.05, optimizer="sgd",
                                       wasgd=jcfg.WASGDConfig(**wkw)), P,
                      rule="wasgd+", mesh=mesh, pipeline=pipeline)
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7,
                             boundary_delay=delay)
    else:
        start = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                  device="cpu")
        tr = Trainer(lambda p, b: (classification_loss(
                         mlp_apply(p, b["x"]), b["y"]), {}), start, axes,
                     tcfg.TrainConfig(learning_rate=0.05, optimizer="sgd",
                                      wasgd=tcfg.WASGDConfig(**wkw)), P,
                     rule="wasgd+", device="cpu", mesh=mesh,
                     pipeline=pipeline)
        ds = OrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7,
                            boundary_delay=delay)
    tr.run(ds, ROUNDS, straggler_schedule=sched)
    return tr, ds


@pytest.mark.parametrize("spec, pipeline, async_mode", [
    ("rs_ag:f32", None, None), ("shard_map:f32", None, None),
    ("rs_ag:f32", "parity", None), ("rs_ag:int8", None, None),
    ("async_rs_ag", None, "on_device"), ("auto", None, None)])
def test_trainer_on_a_mesh_matches_jax(spec, pipeline, async_mode, mesh1):
    tr_j, ds_j = _harness_run("jax", spec, jmesh1(), pipeline, async_mode)
    tr_t, ds_t = _harness_run("port", spec, mesh1, pipeline, async_mode)
    for r, (hj, ht) in enumerate(zip(tr_j.history, tr_t.history)):
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
    pj = jax.tree.map(np.asarray, tr_j.state.params)
    theta = jnp.asarray(tr_j.history[-1]["theta"])
    for k, v in tr_t.state.params.items():
        atol = 1e-5
        if spec == "rs_ag:int8":
            # a code on a rounding boundary may round the other way after
            # a last-bit difference: each round within the codec's bound
            atol = ROUNDS * 2 * float(jcodecs.get_codec("int8").error_bound(
                jnp.asarray(pj[k]), theta, BETA))
        np.testing.assert_allclose(v.numpy(), pj[k], rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(ds_t.order.seeds, ds_j.order.seeds)


def test_pipelined_rs_ag_is_bitwise_unpipelined_on_a_mesh(mesh1):
    plain, _ = _harness_run("port", "rs_ag:f32", mesh1)
    piped, _ = _harness_run("port", "rs_ag:f32", mesh1, pipeline="parity")
    for a, b in zip(plain.history, piped.history):
        for k in ("h", "theta", "scores", "loss", "loss_last"):
            assert np.array_equal(a[k], b[k]), k
    for k, v in plain.state.params.items():
        assert torch.equal(v, piped.state.params[k]), k


def test_phased_round_on_a_mesh_is_the_fused_round(mesh1):
    """run(telemetry=) takes the phase-fenced round: reduce_scatter and
    all_gather phases, the params bitwise the fused round's."""
    from repro_torch.obs import RingSink
    plain, _ = _harness_run("port", "rs_ag:f32", mesh1)
    params_j, axes, _, _ = common.model(0, False)
    X, y = common.dataset(0, False)
    tr = Trainer(lambda p, b: (classification_loss(
                     mlp_apply(p, b["x"]), b["y"]), {}),
                 params_from_numpy(jax.tree.map(np.asarray, params_j),
                                   device="cpu"), axes,
                 tcfg.TrainConfig(learning_rate=0.05, optimizer="sgd",
                                  wasgd=tcfg.WASGDConfig(
                                      tau=TAU, beta=BETA,
                                      backend="rs_ag:f32")), P,
                 rule="wasgd+", device="cpu", mesh=mesh1)
    sink = RingSink()
    tr.run(OrderedDataset({"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}, P, TAU,
                          B_LOCAL, n_segments=2, seed=7),
           ROUNDS, telemetry=sink)
    traces = [e for e in sink.events() if type(e).__name__ == "RoundTrace"]
    assert len(traces) == ROUNDS
    assert {"local_steps", "judge", "reduce_scatter", "all_gather",
            "finalize"} <= set(traces[0].phases)
    for k, v in plain.state.params.items():
        assert torch.equal(v, tr.state.params[k]), k


# ---------------------------------------------------------------------------
# The mesh, and what stays out of scope under it
# ---------------------------------------------------------------------------

def test_make_host_mesh(tmp_path):
    """``make_host_mesh(data, model)`` spans ``data * model`` ranks (a
    (data 2, model 2) mesh runs in ``tests/test_torch_mesh_experts.py``);
    ``model`` 1 keeps the ``("data",)`` mesh."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_host_mesh(1)
    with world1(tmp_path / "store"):
        mesh = make_host_mesh(1)
        assert mesh.mesh_dim_names == ("data",)
        assert mesh.device_type == "cpu"
        assert tsm.mesh_worker_shards(mesh) == 1
        assert tsm.local_rows(4, mesh) == slice(0, 4)
        assert make_host_mesh(1, 1).mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match="group of 1"):
            make_host_mesh(2)
        with pytest.raises(ValueError, match="group of 1"):
            make_host_mesh(1, model=2)


def test_pod_data_mesh_of_one(tmp_path):
    params, axes, theta = _tree(5)
    with world1(tmp_path / "store", ("pod", "data")) as mesh:
        assert tsm.mesh_worker_shards(mesh) == 1
        ours = tbk.get_backend("rs_ag:f32").aggregate(
            _tmap(_t, params), axes, _t(theta), BETA,
            ctx=tbk.AggregationContext(mesh=mesh))
    ref = jbk.get_backend("einsum:f32").aggregate(
        _tmap(jnp.asarray, params), axes, jnp.asarray(theta), BETA)
    _hold(ours, ref, params, "f32", theta)


@pytest.mark.parametrize("spec", ["einsum:f32", "hierarchical:int8",
                                  "pallas_wagg:bf16"])
def test_gathered_spec_holds_no_leaf_between_phases(spec, mesh1):
    """A meshless spec under a mesh gathers each leaf in its finalize: a
    phase-major run keeps no gathered rows across its phases, and gives
    the meshless aggregate bitwise."""
    params, axes, theta = _tree(6)
    backend = tbk.get_backend(spec)
    run = backend.phase_major(_tmap(_t, params), axes, _t(theta),
                              ctx=tbk.AggregationContext(mesh=mesh1,
                                                         n_pods=2))
    run.reduce(0)
    assert len(run.states) == 2
    assert all(st is None for st in run.states.values())
    got = run.finalize(BETA)
    want = backend.aggregate(_tmap(_t, params), axes, _t(theta), BETA,
                             ctx=tbk.AggregationContext(n_pods=2))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)


def _mlp_trainer(mesh, rule="wasgd+", expert_leaf=False, **kw):
    params_j, axes, _, _ = common.model(0, False)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    axes = dict(axes)
    if expert_leaf:
        params["router"] = torch.zeros(3)
        axes["router"] = ("experts",)
    return Trainer(lambda p, b: (classification_loss(
                       mlp_apply(p, b["x"]), b["y"]), {}), params, axes,
                   tcfg.TrainConfig(wasgd=tcfg.WASGDConfig(
                       backend="rs_ag:f32" if mesh else "einsum:f32")), P,
                   rule=rule, device="cpu",
                   mesh=mesh, **kw)


def _run_pair(mesh, rule, rounds=3, **kw):
    """The MLP through ``rule`` for ``rounds`` rounds under the one-rank
    mesh and without one (the same OrderedDataset each way)."""
    X, y = common.dataset(0, False)
    out = []
    for m in (mesh, None):
        tr = _mlp_trainer(m, rule=rule)
        tr.run(OrderedDataset({"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}, P,
                              TAU, B_LOCAL, n_segments=2, seed=7),
               rounds, **kw)
        out.append(tr)
    return out


@pytest.mark.parametrize("rule", ["spsgd", "easgd", "omwu", "mmwu", "seq"])
def test_baseline_rules_under_a_mesh_match_the_meshless_run(rule, mesh1):
    """Every baseline rule runs under the mesh: omwu, mmwu and seq give
    the meshless params bitwise, spsgd and easgd within 1e-6 (the
    all-reduce sums in its own order); h and theta are the meshless
    ones."""
    meshed, plain = _run_pair(mesh1, rule)
    for a, b in zip(meshed.history, plain.history):
        np.testing.assert_allclose(a["h"], b["h"], rtol=1e-6)
        np.testing.assert_array_equal(a["theta"], b["theta"])
    for k, v in plain.state.params.items():
        if rule in ("omwu", "mmwu", "seq"):
            assert torch.equal(meshed.state.params[k], v), k
        else:
            np.testing.assert_allclose(meshed.state.params[k].numpy(),
                                       v.numpy(), rtol=0,
                                       atol=_f32_tol(v.numpy()), err_msg=k)


def test_out_of_scope_under_a_mesh_raises(mesh1, tmp_path):
    """A leaf without the worker axis (JAX's one-copy experts) runs under
    the mesh, whole on the rank, as without one; a mesh that names no
    worker axis is what stays refused."""
    X, y = common.dataset(0, False)
    runs = []
    for m in (mesh1, None):
        tr = _mlp_trainer(m, expert_leaf=True)
        tr.run(OrderedDataset({"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}, P,
                              TAU, B_LOCAL, n_segments=2, seed=7), 3)
        runs.append(tr)
    meshed, plain = runs
    assert meshed.state.params["router"].shape == (3,)
    for k, v in plain.state.params.items():
        np.testing.assert_allclose(meshed.state.params[k].numpy(), v.numpy(),
                                   rtol=0, atol=_f32_tol(v.numpy()),
                                   err_msg=k)
    bad = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    with pytest.raises(ValueError, match="worker axes"):
        _mlp_trainer(bad)


def test_resize_and_checkpoints_run_under_a_mesh(mesh1, tmp_path):
    """``resize``, ``save_checkpoint``, ``resume`` and ``run(
    membership_schedule=, checkpoint_every=, resume_from=)`` under the
    one-rank mesh give the meshless trainer's state."""
    sched = tmem.MembershipSchedule(P, {1: 2, 2: 3})
    meshed, plain = _run_pair(mesh1, "wasgd+", membership_schedule=sched,
                              checkpoint_every=3,
                              checkpoint_path=str(tmp_path / "ck"))
    for k, v in plain.state.params.items():
        np.testing.assert_allclose(meshed.state.params[k].numpy(), v.numpy(),
                                   rtol=0, atol=_f32_tol(v.numpy()),
                                   err_msg=k)
    assert meshed.n_workers == plain.n_workers == 3
    meshed.resize(P, round=3)
    plain.resize(P, round=3)
    for k, v in plain.state.params.items():
        np.testing.assert_allclose(meshed.state.params[k].numpy(), v.numpy(),
                                   rtol=0, atol=_f32_tol(v.numpy()),
                                   err_msg=k)
    ck = str(tmp_path / "ck" / "round_3")
    for tr in (meshed, _mlp_trainer(mesh1)):
        assert tr.resume(ck) == 3
        assert tr.n_workers == P
    X, y = common.dataset(0, False)
    cont = _mlp_trainer(mesh1)
    cont.run(OrderedDataset({"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}, P,
                            TAU, B_LOCAL, n_segments=2, seed=7), 4,
             resume_from=ck)
    assert len(cont.history) == 1
    for k, v in meshed.state.params.items():
        assert v.shape[0] == P, k
