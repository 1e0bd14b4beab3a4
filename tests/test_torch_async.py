"""Alg. 4 straggler rounds in the port against the JAX package.

The MLP of ``tests/test_async_device.py`` (d 8, hidden 16, 3 classes,
``make_classification(0, 256)``), with params made by the JAX package and
exported as numpy, runs through the port and through JAX on the same
batches and the same straggler schedule. Tolerances are JAX's own for its
host simulation against its device path (``_parity_case``): params and
losses atol 1e-5; theta atol 1e-6; schedules bitwise (both draw from
numpy's ``default_rng``). The port's stragglers write the aggregate m
while JAX's simulation writes ``sum_j theta_j new_j``: equal analytically,
not bitwise, hence the 1e-5.
"""
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.func import vmap  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.core import async_device as jad  # noqa: E402
from repro.core import async_sim as jas  # noqa: E402
from repro.core import backends as JB  # noqa: E402
from repro.core.weights import STRATEGIES  # noqa: E402
from repro.data import make_classification as j_make_classification  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.param import build as jbuild  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import async_device as ad  # noqa: E402
from repro_torch.core import async_sim as asim  # noqa: E402
from repro_torch.core import backends as B  # noqa: E402
from repro_torch.core.weights import masked_compute_theta  # noqa: E402
from repro_torch.kernels.wagg import ops as wagg_ops  # noqa: E402
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_mesh import jmesh1, world1  # noqa: E402

ATOL = 1e-5


# ---------------------------------------------------------------------------
# The MLP in both packages
# ---------------------------------------------------------------------------

def _port_loss(p, b):
    return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}


def port_grad_fn(ps, batch):
    """``(losses (w,), grads)`` of the worker-stacked MLP: autograd
    through the ``vmap``ped loss."""
    with torch.enable_grad():
        tracked = tree_map(lambda x: x.detach().requires_grad_(), ps)
        losses = vmap(lambda p, b: _port_loss(p, b)[0])(tracked, batch)
        flat = iter(torch.autograd.grad(losses.sum(), tree_leaves(tracked)))
    return losses.detach(), tree_map(lambda x: next(flat), tracked)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    X, y = j_make_classification(seed, 256, d=8, n_classes=3)
    params, axes = jbuild(functools.partial(
        jcnn.mlp_init, d_in=8, d_hidden=16, n_classes=3), jax.random.key(seed))

    def loss_fn(p, b):
        return jcnn.classification_loss(jcnn.mlp_apply(p, b["x"]),
                                        b["y"]), {}

    def grad_fn(ps, batch):
        one = lambda p, b: loss_fn(p, b)[0]  # noqa: E731
        losses = jax.vmap(one)(ps, batch)
        grads = jax.grad(lambda q: jax.vmap(one)(q, batch).sum())(ps)
        return losses, grads

    return X, y, params, axes, loss_fn, jax.jit(grad_fn)


def _batches(X, y, w, n, seed=0, to=np.asarray):
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(X), size=(w, n))
        yield {"x": to(X[idx]), "y": to(y[idx])}


def _port_params(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _leaf_err(jax_tree, port_tree):
    return max(float(np.abs(np.asarray(jax_tree[k], np.float32)
                            - port_tree[k].float().numpy()).max())
               for k in jax_tree)


def _schedule(w, n_workers, backups, rounds=4, tau=2):
    tm = jas.StepTimeModel(w, sigma=0.3, straggle_p=0.2, straggle_mult=10,
                           seed=3)
    sched = jas.make_schedule(tm, rounds=rounds, tau=tau,
                              n_workers=n_workers, backups=backups)
    assert not sched.active.all(), "schedule must actually drop stragglers"
    return sched


# ---------------------------------------------------------------------------
# Schedules and masked theta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("synchronous", [False, True])
@pytest.mark.parametrize("seed,p,b,sigma,sp", [
    (0, 4, 2, 0.3, 0.3), (3, 3, 1, 0.3, 0.2), (11, 6, 2, 0.2, 0.05),
    (5, 6, 2, 0.05, 0.0)])
def test_make_schedule_is_bitwise_jax(seed, p, b, sigma, sp, synchronous):
    kw = dict(rounds=7, tau=3, n_workers=p, backups=b,
              synchronous=synchronous)
    ours = asim.make_schedule(asim.StepTimeModel(
        p + b, sigma=sigma, straggle_p=sp, straggle_mult=20, seed=seed),
        **kw)
    ref = jas.make_schedule(jas.StepTimeModel(
        p + b, sigma=sigma, straggle_p=sp, straggle_mult=20, seed=seed),
        **kw)
    np.testing.assert_array_equal(ours.active, ref.active)
    np.testing.assert_array_equal(ours.round_wall, ref.round_wall)
    assert ours.round_wall.dtype == ref.round_wall.dtype


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_masked_theta_matches_jax(strategy):
    rng = np.random.default_rng(0)
    for trial in range(8):
        w = int(rng.integers(2, 9))
        losses = rng.uniform(0.05, 5.0, w).astype(np.float32)
        active = np.zeros(w, bool)
        active[rng.choice(w, int(rng.integers(1, w + 1)),
                          replace=False)] = True
        ours = asim.masked_theta(losses, active, 2.0, strategy)
        np.testing.assert_allclose(
            ours, jas.masked_theta(losses, active, 2.0, strategy),
            atol=1e-6, err_msg=f"{strategy} trial {trial}")
        dev = masked_compute_theta(torch.as_tensor(losses),
                                   torch.as_tensor(active), 2.0, strategy)
        np.testing.assert_allclose(dev.numpy(), ours, atol=1e-6)
        assert (ours[~active] == 0.0).all()


def test_masked_theta_rejects_all_false_as_jax_does():
    with pytest.raises(ValueError) as ours:
        asim.masked_theta(np.ones(3, np.float32), np.zeros(3, bool))
    with pytest.raises(ValueError) as ref:
        jas.masked_theta(np.ones(3, np.float32), np.zeros(3, bool))
    assert str(ours.value) == str(ref.value)


def test_validate_active_rounds_as_jax():
    active = np.ones((4, 3), bool)
    active[2] = False
    with pytest.raises(ValueError) as ours:
        ad.validate_active_rounds(active)
    with pytest.raises(ValueError) as ref:
        jad.validate_active_rounds(active)
    assert str(ours.value) == str(ref.value)
    ad.validate_active_rounds(active, rounds=2)


@pytest.mark.parametrize("name", [
    "einsum", "shard_map", "rs_ag", "async_einsum", "async_shard_map",
    "quantized", "hierarchical:int8", "pallas_wagg", "pallas_wagg:int8",
    "einsum:bf16"])
def test_async_backend_name_as_jax(name):
    assert ad.async_backend_name(name) == jad.async_backend_name(name)


def test_async_backend_name_unknown_and_mesh(tmp_path):
    """The mesh backends raise JAX's missing-mesh error without a mesh,
    and under a one-rank gloo mesh the on-device rounds match JAX's on a
    one-device mesh."""
    with pytest.raises(ValueError, match="no async"):
        ad.async_backend_name("does_not_exist")
    X, y, params, axes, _, grad_fn = _setup()
    sched = _schedule(4, 3, 1)
    for backend in ("async_shard_map", "async_rs_ag", "shard_map:f32"):
        with pytest.raises(ValueError, match="needs ctx.mesh"):
            ad.build_async_round(port_grad_fn, axes, lr=0.1,
                                 backend=backend)
        with pytest.raises(ValueError, match="needs ctx.mesh"):
            jad.build_async_round(grad_fn, axes, lr=0.1, backend=backend)
        ref = jad.run_parallel_sgd_on_device(
            grad_fn, params, axes, _batches(X, y, 4, 8, to=jnp.asarray),
            n_workers=3, backups=1, tau=2, rounds=4, lr=0.05,
            schedule=sched, backend=backend,
            ctx=JB.AggregationContext(mesh=jmesh1()))
        with world1(tmp_path / f"store_{backend}") as mesh:
            ours = _port_device_run(sched, 3, 1, backend=backend,
                                    ctx=B.AggregationContext(mesh=mesh))
        _hold(ours, ref)


def test_weighted_aggregate_async_einsum_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    w = 4
    xs = {"a": rng.normal(size=(w, 6, 5)).astype(np.float32),
          "b": rng.normal(size=(w, 33)).astype(np.float32)}
    axes = {"a": ("worker", None, None), "b": ("worker", None)}
    active = np.array([True, False, True, True])
    theta = asim.masked_theta(np.array([0.5, 1.0, 2.0, 0.1], np.float32),
                              active, 2.0)
    ref = jad.weighted_aggregate_async(
        jax.tree.map(jnp.asarray, xs), axes, jnp.asarray(theta),
        jnp.asarray(active), 0.9, schedule="einsum")
    ours = ad.weighted_aggregate_async(
        {k: torch.as_tensor(v) for k, v in xs.items()}, axes,
        torch.as_tensor(theta), torch.as_tensor(active), 0.9,
        schedule="einsum")
    assert _leaf_err(ref, ours) < 1e-6
    for sched in ("all_reduce", "rs_ag"):
        with pytest.raises(ValueError, match="needs ctx.mesh"):
            ad.weighted_aggregate_async(
                {k: torch.as_tensor(v) for k, v in xs.items()}, axes,
                torch.as_tensor(theta), None, 0.9, schedule=sched)
        ref = jad.weighted_aggregate_async(
            jax.tree.map(jnp.asarray, xs), axes, jnp.asarray(theta),
            jnp.asarray(active), 0.9, mesh=jmesh1(), schedule=sched)
        with world1(tmp_path / f"store_{sched}") as mesh:
            ours = ad.weighted_aggregate_async(
                {k: torch.as_tensor(v) for k, v in xs.items()}, axes,
                torch.as_tensor(theta), torch.as_tensor(active), 0.9,
                mesh=mesh, schedule=sched)
        assert _leaf_err(ref, ours) < 1e-6
    with pytest.raises(ValueError, match="unknown async schedule"):
        ad.weighted_aggregate_async({}, {}, torch.ones(2), None, 0.9,
                                    schedule="nope")


# ---------------------------------------------------------------------------
# The runs: the port's device round against JAX's host simulation
# ---------------------------------------------------------------------------

def _jax_host_run(sched, n_workers, backups, rounds=4, tau=2, **kw):
    X, y, params, axes, loss_fn, grad_fn = _setup()
    w = n_workers + backups
    return jas.run_parallel_sgd(
        loss_fn, grad_fn, params, axes, _batches(X, y, w, tau * 4,
                                                 to=jnp.asarray),
        n_workers=n_workers, backups=backups, tau=tau, rounds=rounds,
        lr=0.05, schedule=sched, **kw)


def _port_device_run(sched, n_workers, backups, rounds=4, tau=2, **kw):
    X, y, params, axes, _, _ = _setup()
    w = n_workers + backups
    return ad.run_parallel_sgd_on_device(
        port_grad_fn, _port_params(params), axes,
        _batches(X, y, w, tau * 4), n_workers=n_workers, backups=backups,
        tau=tau, rounds=rounds, lr=0.05, schedule=sched, device="cpu", **kw)


def _hold(ours, ref):
    assert ours.wall == ref.wall
    assert ours.dropped_rounds == ref.dropped_rounds
    np.testing.assert_allclose(ours.losses, ref.losses, atol=ATOL)
    err = _leaf_err(ref.params, ours.params)
    assert err < ATOL, err


@pytest.mark.parametrize("backend", ["async_einsum", "pallas_wagg"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_on_device_round_matches_jax_host_sim(strategy, backend):
    """Every strategy under einsum and pallas_wagg (the plain version of
    the CUDA kernel on the CPU), p 3 + b 1, 4 rounds."""
    sched = _schedule(4, 3, 1)
    ref = _jax_host_run(sched, 3, 1, strategy=strategy)
    ours = _port_device_run(sched, 3, 1, strategy=strategy, backend=backend)
    _hold(ours, ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_hierarchical_int8_round_matches_jax_device_round(strategy):
    """``hierarchical:int8`` with 2 pods: the stragglers adopt the
    decoded int8 aggregate, which the host simulation's ``sum_j theta_j
    new_j`` reaches only up to (1-beta) times the codec's error, so the
    port is held to JAX's own device round here."""
    X, y, params, axes, _, grad_fn = _setup()
    sched = _schedule(4, 3, 1)
    ref = jad.run_parallel_sgd_on_device(
        grad_fn, params, axes, _batches(X, y, 4, 8, to=jnp.asarray),
        n_workers=3, backups=1, tau=2, rounds=4, lr=0.05, schedule=sched,
        strategy=strategy, backend="hierarchical:int8",
        ctx=JB.AggregationContext(n_pods=2))
    ours = _port_device_run(sched, 3, 1, strategy=strategy,
                            backend="hierarchical:int8",
                            ctx=B.AggregationContext(n_pods=2))
    _hold(ours, ref)


@pytest.mark.parametrize("policy", [
    "ema(0.9)", "trimmed(1)", "boltzmann(a=2)|anneal(linear, rate=0.2)"])
def test_policy_round_matches_jax_host_sim(policy):
    sched = _schedule(6, 4, 2, rounds=5)
    ref = _jax_host_run(sched, 4, 2, rounds=5, policy=policy)
    ours = _port_device_run(sched, 4, 2, rounds=5, policy=policy,
                            backend="async_einsum")
    _hold(ours, ref)


@pytest.mark.parametrize("strategy", ["boltzmann", "best"])
def test_port_host_sim_matches_jax_host_sim(strategy):
    """The port's own oracle, ``async_sim.run_parallel_sgd``, and its
    equality with the port's device round."""
    X, y, params, axes, _, _ = _setup()
    sched = _schedule(4, 3, 1)
    ref = _jax_host_run(sched, 3, 1, strategy=strategy)
    ours = asim.run_parallel_sgd(
        _port_loss, port_grad_fn, _port_params(params), axes,
        _batches(X, y, 4, 8), n_workers=3, backups=1, tau=2, rounds=4,
        lr=0.05, schedule=sched, strategy=strategy)
    _hold(ours, ref)
    dev = _port_device_run(sched, 3, 1, strategy=strategy,
                           backend="pallas_wagg")
    _hold(dev, ours)


def test_runs_need_a_time_source():
    X, y, params, axes, _, _ = _setup()
    with pytest.raises(ValueError, match="time_model"):
        asim.run_parallel_sgd(_port_loss, port_grad_fn, _port_params(params),
                              axes, _batches(X, y, 4, 4), n_workers=3,
                              backups=1, tau=2, rounds=2, lr=0.1)
    with pytest.raises(ValueError, match="time_model"):
        _port_device_run(None, 3, 1, backend="async_einsum")
    with pytest.raises(ValueError, match="measure_times"):
        _port_device_run(_schedule(4, 3, 1), 3, 1, backend="async_einsum",
                         measure_times=True)
    bad = np.ones((4, 4), bool)
    bad[2] = False
    with pytest.raises(ValueError, match="no active worker in round"):
        _port_device_run(asim.StragglerSchedule(bad, np.ones(4)), 3, 1,
                         backend="async_einsum")


def test_time_model_drives_both_packages_alike():
    """``time_model=`` instead of a schedule: both draw the same one."""
    X, y, params, axes, loss_fn, grad_fn = _setup()
    ref = jas.run_parallel_sgd(
        loss_fn, grad_fn, params, axes, _batches(X, y, 6, 8, to=jnp.asarray),
        n_workers=4, backups=2, tau=2, rounds=4, lr=0.05,
        time_model=jas.StepTimeModel(6, sigma=0.3, straggle_p=0.2, seed=5))
    ours = ad.run_parallel_sgd_on_device(
        port_grad_fn, _port_params(params), axes, _batches(X, y, 6, 8),
        n_workers=4, backups=2, tau=2, rounds=4, lr=0.05,
        time_model=asim.StepTimeModel(6, sigma=0.3, straggle_p=0.2, seed=5),
        backend="einsum", device="cpu")
    _hold(ours, ref)


def test_measured_times_match_jax():
    """``measure_times=True`` with ``ema(0.9)|time_aware``: one device
    gives every worker the same time, so both pick workers 0..p-1 each
    round and the time ratios are 1."""
    X, y, params, axes, _, grad_fn = _setup()
    kw = dict(n_workers=3, backups=1, tau=2, rounds=4, lr=0.05,
              measure_times=True, policy="ema(0.9)|time_aware")
    ref = jad.run_parallel_sgd_on_device(
        grad_fn, params, axes, _batches(X, y, 4, 8, to=jnp.asarray),
        backend="async_einsum", **kw)
    ours = ad.run_parallel_sgd_on_device(
        port_grad_fn, _port_params(params), axes, _batches(X, y, 4, 8),
        backend="pallas_wagg", device="cpu", **kw)
    assert ours.round_times.shape == ref.round_times.shape == (4, 4)
    assert (ours.round_times == ours.round_times[:, :1]).all()
    assert ours.dropped_rounds == ref.dropped_rounds == 4
    np.testing.assert_allclose(ours.losses, ref.losses, atol=ATOL)
    assert _leaf_err(ref.params, ours.params) < ATOL
    assert ad.measure_round_times(torch.zeros(4), 4).shape == (4,)


# ---------------------------------------------------------------------------
# The Alg. 4 rule and Trainer.run(straggler_schedule=)
# ---------------------------------------------------------------------------

def _stacked(w, seed=0):
    rng = np.random.default_rng(seed)
    params = {"blk": {"w": rng.normal(size=(w, 6, 5)).astype(np.float32)},
              "head": rng.normal(size=(w, 33)).astype(np.float32)}
    axes = {"blk": {"w": ("worker", None, None)}, "head": ("worker", None)}
    return params, axes


def test_async_rule_all_active_equals_sync_rule():
    params, axes = _stacked(4)
    pt = tree_map(torch.as_tensor, params)
    h = torch.tensor([0.5, 1.0, 2.0, 0.1])
    sync = step_mod.wasgd_rule(WASGDConfig())(pt, axes, h, ())[0]
    asy = step_mod.async_wasgd_rule(WASGDConfig(async_mode="on_device"))(
        pt, axes, h, torch.ones(4, dtype=torch.bool))[0]
    for a, b in zip(tree_leaves(sync), tree_leaves(asy)):
        assert float((a - b).abs().max()) < 1e-6


def test_async_rule_anneal_rides_comm_state_with_mask():
    """A stateful policy's state rides beside the mask; each round's theta
    and the final counter as JAX's rule gives them."""
    params, axes = _stacked(4)
    kw = dict(async_mode="on_device", a_schedule="anneal", anneal_rate=0.5,
              a_tilde=2.0, backend="pallas_wagg:f32")
    jrule = jstep.async_wasgd_rule(JWASGDConfig(**kw))
    rule = step_mod.async_wasgd_rule(WASGDConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    pt = tree_map(torch.as_tensor, params)
    jcs = jstep.init_comm_state("wasgd", jp, axes, 4,
                                wcfg=JWASGDConfig(**kw))
    cs = step_mod.init_comm_state("wasgd", pt, axes, 4,
                                  wcfg=WASGDConfig(**kw))
    assert set(cs) == set(jcs) == {"active", "policy"}
    h = np.array([0.5, 1.0, 2.0, 0.1], np.float32)
    for mask in ([True, False, True, True], [False, True, True, True],
                 [True, True, True, True]):
        jcs = {**jcs, "active": jnp.asarray(mask)}
        cs = {**cs, "active": torch.as_tensor(mask)}
        jp, jcs, jtheta, jm = jrule(jp, axes, jnp.asarray(h), jcs)
        pt, cs, theta, m = rule(pt, axes, torch.as_tensor(h), cs)
        np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta),
                                   atol=1e-6)
        np.testing.assert_array_equal(m["active"].numpy(),
                                      np.asarray(jm["active"]))
        assert _leaf_err(jp["blk"], pt["blk"]) < 1e-6
    assert float(cs["policy"]["t"]) == float(jcs["policy"]["t"]) == 3.0


def test_async_rule_casts_the_mask_once_a_round(monkeypatch):
    """The round's one grouped kernel call takes every leaf and the
    rule's float32 mask: one cast a round, not one a leaf."""
    seen = []
    real = wagg_ops.wagg_fused_many

    def spy(xs, theta, beta, payloads=None, scales=None, active=None):
        seen.append((len(xs), active))
        return real(xs, theta, beta, payloads=payloads, scales=scales,
                    active=active)

    monkeypatch.setattr(wagg_ops, "wagg_fused_many", spy)
    params, axes = _stacked(4)
    rule = step_mod.async_wasgd_rule(WASGDConfig(async_mode="on_device",
                                                 backend="pallas_wagg:f32"))
    _, _, theta, m = rule(tree_map(torch.as_tensor, params), axes,
                          torch.tensor([0.5, 1.0, 2.0, 0.1]),
                          torch.tensor([True, False, True, True]))
    assert len(seen) == 1 and seen[0][0] == 2
    assert seen[0][1].dtype == torch.float32 and seen[0][1] is m["active"]
    assert float(theta[1]) == 0.0


def _trainer_pair(w, tau=2, policy="", backend="", rule="wasgd",
                  async_mode="on_device"):
    X, y = j_make_classification(0, 512, d=8, n_classes=3)
    _, _, params, axes, loss_fn, _ = _setup()
    wkw = dict(tau=tau, async_mode=async_mode, backend=backend,
               policy=policy)
    jt = JTrainer(loss_fn, params, axes,
                  JTrainConfig(learning_rate=0.05,
                               wasgd=JWASGDConfig(**wkw)), w, rule=rule)
    pt = Trainer(_port_loss, _port_params(params), axes,
                 TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(**wkw)),
                 w, rule=rule, device="cpu")

    def batches(to=np.asarray):
        rng = np.random.default_rng(0)
        while True:
            idx = rng.integers(0, len(X), size=tau * w * 4)
            yield {"x": to(X[idx]), "y": to(y[idx])}

    return jt, pt, batches


@pytest.mark.parametrize("policy,backend", [
    ("", "pallas_wagg:f32"), ("ema(0.9)", ""), ("trimmed(1)", "einsum")])
def test_trainer_straggler_run_matches_jax_round_by_round(policy, backend):
    w, p = 6, 4
    jt, pt, batches = _trainer_pair(w, policy=policy, backend=backend)
    sched = jas.make_schedule(jas.StepTimeModel(w, sigma=0.3, straggle_p=0.3,
                                                seed=1),
                              rounds=5, tau=2, n_workers=p, backups=w - p)
    jsnap, psnap = [], []
    jt.run(batches(jnp.asarray), 5, straggler_schedule=sched,
           serve_hook=lambda r, ps, ax: jsnap.append(
               jax.tree.map(np.asarray, ps)))
    pt.run(batches(), 5, straggler_schedule=sched,
           serve_hook=lambda r, ps, ax: psnap.append(
               {k: v.clone() for k, v in ps.items()}))
    for r, (hj, hp) in enumerate(zip(jt.history, pt.history)):
        np.testing.assert_array_equal(hp["active"], hj["active"])
        np.testing.assert_array_equal(hp["active"],
                                      sched.active[r].astype(np.float32))
        np.testing.assert_allclose(hp["h"], hj["h"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(hp["theta"], hj["theta"], atol=1e-6)
        np.testing.assert_allclose(hp["loss"], hj["loss"], atol=1e-5,
                                   rtol=1e-5)
        assert (hp["theta"][~sched.active[r]] == 0.0).all()
        np.testing.assert_allclose(hp["theta"].sum(), 1.0, rtol=1e-5)
        assert _leaf_err(jsnap[r], psnap[r]) < ATOL, r


def _refusal_cases():
    short = np.ones((2, 4), bool)
    empty = np.ones((4, 4), bool)
    empty[1] = False
    return {
        "mode": (dict(async_mode="host_sim"), 2, np.ones((2, 4), bool)),
        "rule": (dict(rule="spsgd"), 2, np.ones((2, 4), bool)),
        "short": ({}, 5, short),
        "all_straggler": ({}, 4, empty),
    }


@pytest.mark.parametrize("case", ["mode", "rule", "short", "all_straggler"])
def test_trainer_refuses_as_jax_does(case):
    kw, rounds, sched = _refusal_cases()[case]
    jt, pt, batches = _trainer_pair(4, **kw)
    with pytest.raises(ValueError) as ref:
        jt.run(batches(jnp.asarray), rounds, straggler_schedule=sched)
    with pytest.raises(ValueError) as ours:
        pt.run(batches(), rounds, straggler_schedule=sched)
    assert str(ours.value) == str(ref.value)
    assert pt.history == []


def test_async_mode_runs_all_active_without_a_schedule():
    """An on_device trainer run without a schedule keeps its all-active
    mask, and equals the synchronous trainer."""
    _, pt, batches = _trainer_pair(4)
    _, ps, _ = _trainer_pair(4, async_mode="host_sim")
    pt.run(batches(), 3)
    ps.run(batches(), 3)
    for hp, hs in zip(pt.history, ps.history):
        np.testing.assert_array_equal(hp["active"], np.ones(4, np.float32))
        np.testing.assert_allclose(hp["theta"], hs["theta"], atol=1e-6)
    for a, b in zip(tree_leaves(pt.state.params),
                    tree_leaves(ps.state.params)):
        assert float((a - b).abs().max()) < 1e-6
