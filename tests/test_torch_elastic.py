"""Elastic worker membership in the port against the JAX package: the
WorkerSet and schedules, every resize helper, the data side, and
``Trainer.resize`` / ``run(membership_schedule=)`` / a resume at another
worker count, round by round against the JAX Trainer.

Tolerances: schedules, seeds, survivors' rows and masks bitwise; a
newcomer's row (an f32 tensordot in each package) 1e-6; training rounds
as ``tests/test_torch_async.py`` holds them (params 1e-5, h and loss
1e-5, theta 1e-6).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.core import async_device as jad  # noqa: E402
from repro.core import membership as jmem  # noqa: E402
from repro.core.aggregate import resize_worker_leaves as j_resize_leaves  # noqa: E402
from repro.core.aggregate import strip_worker_axis as j_strip  # noqa: E402
from repro.core.order import OrderState as JOrderState  # noqa: E402
from repro.core.weights import parse_policy as j_parse_policy  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.data import make_classification as j_make_classification  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.param import build as jbuild  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import async_device as ad  # noqa: E402
from repro_torch.core import membership as mem  # noqa: E402
from repro_torch.core.aggregate import (resize_worker_leaves,  # noqa: E402
                                        strip_worker_axis)
from repro_torch.core.order import OrderState  # noqa: E402
from repro_torch.core.weights import parse_policy  # noqa: E402
from repro_torch.data import OrderedDataset  # noqa: E402
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import state as pstate_mod  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree, prefix=""):
    """Flat key -> numpy leaf of a dict / NamedTuple / tuple tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}@{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}#{i}"))
        return out
    return {prefix: _np(tree)}


def _hold_trees(ours, ref, atol=0.0):
    a, b = _flat(ours), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape == b[k].shape, k
        if atol:
            np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- WorkerSet and schedules -----------------------------------------------

def test_workerset_lifecycle_as_jax():
    ours, ref = mem.WorkerSet(4), jmem.WorkerSet(4)
    for new_p, r in ((6, 3), (6, None), (2, 5), (2, 6), (5, 9)):
        a, b = ours.resize(new_p, round=r), ref.resize(new_p, round=r)
        assert (a.round, a.old_p, a.new_p) == (b.round, b.old_p, b.new_p)
        assert ours.p == ref.p and ours.generation == ref.generation
    assert len(ours.log) == len(ref.log) == 5
    for bad in (lambda: ours.resize(0), lambda: mem.WorkerSet(0)):
        with pytest.raises(ValueError):
            bad()


def test_membership_schedule_p_of_as_jax():
    ours, ref = (m.MembershipSchedule(4, {3: 6, 7: 2, 12: 5})
                 for m in (mem, jmem))
    assert [ours.p_of(r) for r in range(20)] == \
        [ref.p_of(r) for r in range(20)]
    assert [ours.max_p(n) for n in (1, 5, 9, 20)] == \
        [ref.max_p(n) for n in (1, 5, 9, 20)]
    assert repr(ours) == repr(ref)
    with pytest.raises(ValueError):
        mem.MembershipSchedule(4, {2: 0})
    with pytest.raises(ValueError):
        mem.MembershipSchedule(0)


@pytest.mark.parametrize("p0,rounds,seed,kw", [
    (4, 32, 7, {}), (8, 30, 7, {}), (4, 12, 2, {}), (3, 50, 0, {}),
    (6, 40, 11, {"event_prob": 0.8, "min_p": 2, "max_p": 9})])
def test_chaos_schedule_is_bitwise_jax(p0, rounds, seed, kw):
    ours = mem.make_chaos_schedule(p0, rounds, seed=seed, **kw)
    ref = jmem.make_chaos_schedule(p0, rounds, seed=seed, **kw)
    assert ours.events == ref.events and ours.events
    assert ours.p0 == ref.p0


# -- params, masks, policy and optimizer state --------------------------------

def _stacked(p, dtype=np.float32):
    rng = np.random.default_rng(p)
    params = {"w": rng.normal(size=(p, 3, 2)).astype(dtype),
              "b": rng.normal(size=(p, 5)).astype(dtype),
              "shared": np.ones((2,), np.float32)}
    axes = {"w": ("worker", None, None), "b": ("worker", None),
            "shared": (None,)}
    return params, axes


@pytest.mark.parametrize("new_p", [1, 2, 4, 6, 9])
@pytest.mark.parametrize("weighted", [False, True])
def test_resize_worker_leaves_as_jax(new_p, weighted):
    params, axes = _stacked(4)
    theta = np.array([0.1, 0.4, 0.2, 0.3], np.float32) if weighted else None
    ours = resize_worker_leaves(
        {k: torch.as_tensor(v) for k, v in params.items()}, axes, new_p,
        theta=None if theta is None else torch.as_tensor(theta))
    ref = j_resize_leaves(jax.tree.map(jnp.asarray, params), axes, new_p,
                          theta=None if theta is None else jnp.asarray(theta))
    keep = min(4, new_p)
    for k in ("w", "b"):
        assert ours[k].shape == ref[k].shape
        np.testing.assert_array_equal(ours[k].numpy()[:keep],
                                      params[k][:keep])
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)
    np.testing.assert_array_equal(ours["shared"].numpy(), params["shared"])
    assert strip_worker_axis(axes) == j_strip(axes)
    with pytest.raises(ValueError):
        resize_worker_leaves(params, axes, 0)


@pytest.mark.parametrize("mask,new_p", [
    ([True, False, True, True], 2), ([True, False, True, True], 6),
    ([False, True], 5), ([True, True, False], 3)])
def test_resize_active_mask_as_jax(mask, new_p):
    ours = ad.resize_active_mask(torch.as_tensor(mask), new_p)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jad.resize_active_mask(jnp.asarray(mask),
                                                        new_p)))


def test_resize_active_mask_refuses_an_empty_shrink_as_jax():
    with pytest.raises(ValueError) as ours:
        ad.resize_active_mask(torch.tensor([False, False, True]), 2)
    with pytest.raises(ValueError) as ref:
        jad.resize_active_mask(jnp.asarray([False, False, True]), 2)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError):
        ad.resize_active_mask(torch.ones(3, dtype=torch.bool), 0)


@pytest.mark.parametrize("spec", [
    "ema(0.5)|boltzmann", "ema|time_aware|boltzmann",
    "boltzmann(a=2)|anneal(linear, rate=0.2)", "boltzmann"])
@pytest.mark.parametrize("new_p", [2, 3, 5])
def test_policy_expand_state_as_jax(spec, new_p):
    """Three rounds (one with a straggler, one with times observed), then
    the resize; the state is held leaf for leaf."""
    ours, ref = parse_policy(spec), j_parse_policy(spec)
    st, jst = ours.init_state(3), ref.init_state(3)
    for h, act in (([1.0, 2.0, 3.0], None), ([2.0, 0.5, 1.5],
                                             [True, False, True]),
                   ([0.7, 1.1, 0.9], None)):
        a = None if act is None else torch.tensor(act)
        ja = None if act is None else jnp.asarray(act)
        _, st = ours(torch.tensor(h), a, st)
        _, jst = ref(jnp.asarray(h, jnp.float32), ja, jst)
        st = ours.observe_times(st, np.array([1.0, 2.0, 1.5]))
        jst = ref.observe_times(jst, jnp.asarray([1.0, 2.0, 1.5]))
    _hold_trees(ours.expand_state(st, new_p), ref.expand_state(jst, new_p),
                atol=1e-6)


def test_resize_comm_state_as_jax():
    pol, jpol = parse_policy("ema|boltzmann"), j_parse_policy("ema|boltzmann")
    mask = [True, False, True, True]
    for new_p in (2, 6):
        assert mem.resize_comm_state((), new_p) == ()
        _hold_trees(mem.resize_comm_state(torch.tensor(mask), new_p),
                    jmem.resize_comm_state(jnp.asarray(mask), new_p))
        _hold_trees(
            mem.resize_comm_state({"active": torch.tensor(mask),
                                   "policy": pol.init_state(4)}, new_p,
                                  policy=pol),
            jmem.resize_comm_state({"active": jnp.asarray(mask),
                                    "policy": jpol.init_state(4)}, new_p,
                                   policy=jpol))
        _hold_trees(mem.resize_comm_state(pol.init_state(4), new_p,
                                          policy=pol),
                    jmem.resize_comm_state(jpol.init_state(4), new_p,
                                           policy=jpol))
    with pytest.raises(ValueError, match="no elastic"):
        mem.resize_comm_state(object(), 3)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("new_p", [2, 6])
def test_resize_opt_state_as_jax(opt_name, new_p):
    params, axes = _stacked(4)
    grads, _ = _stacked(4)
    grads = {k: v * 0.5 for k, v in grads.items()}
    opt = make_optimizer(opt_name, 0.1, 0.9, 0.01)
    jopt = j_make_optimizer(opt_name, 0.1, 0.9, 0.01)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    st, jst = opt.init(tp), jopt.init(jp)
    for _ in range(2):
        tp, st = opt.update({k: torch.as_tensor(v) for k, v in grads.items()},
                            st, tp)
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp)
    _hold_trees(mem.resize_opt_state(st, axes, new_p),
                jmem.resize_opt_state(jst, axes, new_p), atol=1e-6)


@pytest.mark.parametrize("wkw", [
    dict(policy="ema|boltzmann", async_mode="on_device"),
    dict(async_mode="on_device"), dict(policy="ema|boltzmann"), dict()])
def test_resize_train_state_as_jax(wkw):
    params, axes = _stacked(4)
    wcfg, jwcfg = WASGDConfig(tau=2, **wkw), JWASGDConfig(tau=2, **wkw)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    opt = make_optimizer("adamw", 1e-3, 0.0, 0.01)
    jopt = j_make_optimizer("adamw", 1e-3, 0.0, 0.01)
    st = pstate_mod.init_state(tp, opt.init(tp), 4, step_mod.init_comm_state(
        "wasgd+", tp, axes, 4, wcfg=wcfg))
    jst = jstate.init_state(jp, jopt.init(jp), 4, jstep.init_comm_state(
        "wasgd+", jp, axes, 4, wcfg=jwcfg))
    st = st._replace(energy=torch.tensor([1.0, 2.0, 3.0, 4.0]))
    jst = jst._replace(energy=jnp.asarray([1.0, 2.0, 3.0, 4.0]))
    pol = parse_policy(wcfg.policy) if wcfg.policy else None
    jpol = j_parse_policy(jwcfg.policy) if jwcfg.policy else None
    for new_p in (6, 3):
        ours = mem.resize_train_state(st, axes, new_p, policy=pol)
        ref = jmem.resize_train_state(jst, axes, new_p, policy=jpol)
        _hold_trees(ours._replace(step=0), ref._replace(step=0), atol=1e-6)
        np.testing.assert_array_equal(ours.params["w"].numpy()[:3],
                                      params["w"][:3])
        # the comm state's re-shard through init_comm_state(prev=)
        _hold_trees(step_mod.init_comm_state("wasgd+", tp, axes, new_p,
                                             wcfg=wcfg, prev=st.comm_state),
                    jstep.init_comm_state("wasgd+", jp, axes, new_p,
                                          wcfg=jwcfg, prev=jst.comm_state))
    with pytest.raises(ValueError, match="no elastic"):
        step_mod.init_comm_state("easgd", tp, axes, 6, prev=st.comm_state)


# -- data side ---------------------------------------------------------------

def test_order_state_resize_is_bitwise_jax():
    ours, ref = OrderState(4, 2, base_seed=1), JOrderState(4, 2, base_seed=1)
    for new_p in (6, 3, 7, 7, 1, 5):
        ours.record_scores(0, np.arange(ours.seeds.shape[1]) - 2.0)
        ref.record_scores(0, np.arange(ref.seeds.shape[1]) - 2.0)
        np.testing.assert_array_equal(ours.end_segment(0),
                                      ref.end_segment(0))
        before = ours.seeds.copy()
        ours.resize(new_p)
        ref.resize(new_p)
        np.testing.assert_array_equal(ours.seeds, ref.seeds)
        np.testing.assert_array_equal(ours.scores, ref.scores)
        keep = min(before.shape[1], new_p)
        np.testing.assert_array_equal(ours.seeds[:, :keep],
                                      before[:, :keep])
    with pytest.raises(ValueError):
        ours.resize(0)


def test_ordered_dataset_resize_is_bitwise_jax():
    X, y = j_make_classification(0, 256, d=4, n_classes=2)
    ours = OrderedDataset({"x": X, "y": y}, 4, tau=2, b_local=4,
                          n_segments=2)
    ref = JOrderedDataset({"x": X, "y": y}, 4, tau=2, b_local=4,
                          n_segments=2)
    a, b = ours.batches(), ref.batches()
    r = 0
    for new_p, rounds in ((4, 3), (6, 5), (3, 4), (5, 6)):
        if new_p != ours.p:
            ours.resize(new_p)
            ref.resize(new_p)
            a, b = ours.batches(start_round=r), ref.batches(start_round=r)
        for _ in range(rounds):
            ba, bb = next(a), next(b)
            assert ba["x"].shape[0] == 2 * new_p * 4
            np.testing.assert_array_equal(ba["x"], bb["x"])
            np.testing.assert_array_equal(ba["y"], bb["y"])
            r += 1


# -- the Trainer -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    X, y = j_make_classification(seed, 1024, d=16, n_classes=4)
    params, axes = jbuild(functools.partial(
        jcnn.mlp_init, d_in=16, d_hidden=32, n_classes=4),
        jax.random.key(seed))

    def loss_fn(p, b):
        return jcnn.classification_loss(jcnn.mlp_apply(p, b["x"]),
                                        b["y"]), {}

    return X, y, params, axes, loss_fn


def _port_loss(p, b):
    return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}


def _pair(p, seed=0, rule="wasgd+", **wkw):
    X, y, params, axes, loss_fn = _setup(seed)
    tkw = dict(learning_rate=0.05, optimizer=wkw.pop("optimizer", "sgd"))
    jt = JTrainer(loss_fn, params, axes, JTrainConfig(
        wasgd=JWASGDConfig(tau=2, **wkw), **tkw), p, rule=rule)
    pt = Trainer(_port_loss, params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"), axes, TrainConfig(
        wasgd=WASGDConfig(tau=2, **wkw), **tkw), p, rule=rule, device="cpu")
    data = {"x": X, "y": y}
    return (jt, JOrderedDataset(data, p, 2, 8, n_segments=2),
            pt, OrderedDataset(data, p, 2, 8, n_segments=2))


def _run_both(jt, jds, pt, pds, n_rounds, **kw):
    jsnap, psnap = [], []
    jt.run(jds, n_rounds, serve_hook=lambda r, ps, ax: jsnap.append(
        jax.tree.map(np.asarray, ps)), **kw)
    pt.run(pds, n_rounds, serve_hook=lambda r, ps, ax: psnap.append(
        {k: v.numpy().copy() for k, v in ps.items()}), **kw)
    return jsnap, psnap


def _hold_rounds(jt, pt, jsnap, psnap):
    assert len(jt.history) == len(pt.history) == len(jsnap) == len(psnap)
    for r, (hj, hp) in enumerate(zip(jt.history, pt.history)):
        assert hp.get("p") == hj.get("p"), r
        for k in ("h", "loss"):
            np.testing.assert_allclose(hp[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} round {r}")
        np.testing.assert_allclose(hp["theta"], hj["theta"], atol=1e-6,
                                   err_msg=f"theta round {r}")
        for k in jsnap[r]:
            np.testing.assert_allclose(psnap[r][k], jsnap[r][k], atol=1e-5,
                                       err_msg=f"{k} round {r}")


@pytest.mark.parametrize("wkw", [
    dict(policy="ema|boltzmann"),
    dict(policy="ema(0.9)|time_aware", async_mode="on_device",
         backend="pallas_wagg:f32"),
    dict(optimizer="momentum", backend="pallas_wagg:f32")])
def test_membership_run_matches_jax_round_by_round(wkw):
    """A chaos walk of 12 rounds that shrinks and grows the fleet."""
    sched = mem.make_chaos_schedule(4, 12, seed=2)
    jt, jds, pt, pds = _pair(4, seed=3, **wkw)
    jsnap, psnap = _run_both(jt, jds, pt, pds, 12,
                             membership_schedule=sched)
    _hold_rounds(jt, pt, jsnap, psnap)
    ps = [h["p"] for h in pt.history]
    assert ps == [sched.p_of(r) for r in range(12)] and len(set(ps)) > 1
    assert pt.n_workers == jt.n_workers == sched.p_of(11)
    assert pt.workers.generation == jt.workers.generation


def test_trainer_resize_matches_jax():
    jt, _, pt, _ = _pair(4, policy="ema|boltzmann", async_mode="on_device")
    before = {k: v.clone() for k, v in pt.state.params.items()}
    for new_p, r in ((6, 0), (6, 1), (3, 2), (5, 3)):
        ev, jev = pt.resize(new_p, round=r), jt.resize(new_p, round=r)
        assert (ev is None) == (jev is None)
        if ev is not None:
            assert (ev.round, ev.old_p, ev.new_p) == \
                (jev.round, jev.old_p, jev.new_p)
        assert pt.n_workers == jt.n_workers == new_p
        _hold_trees(pt.state._replace(step=0), jt.state._replace(step=0),
                    atol=1e-6)
    for k, v in pt.state.params.items():
        np.testing.assert_array_equal(v[:3].numpy(), before[k][:3].numpy())


@pytest.mark.parametrize("case", ["easgd", "iterator", "exclusive"])
def test_trainer_membership_refusals_as_jax(case):
    rule = "easgd" if case == "easgd" else "wasgd+"
    wkw = dict(async_mode="on_device") if case == "exclusive" else {}
    jt, jds, pt, pds = _pair(2, rule=rule, **wkw)
    sched = mem.MembershipSchedule(2, {1: 3})
    jsched = jmem.MembershipSchedule(2, {1: 3})

    def call(tr, ds, s):
        if case == "easgd":
            return tr.resize(3)
        if case == "iterator":
            return tr.run(ds.batches(), 4, membership_schedule=s)
        return tr.run(ds, 4, membership_schedule=s,
                      straggler_schedule=np.ones((4, 2), bool))

    with pytest.raises(ValueError) as ref:
        call(jt, jds, jsched)
    with pytest.raises(ValueError) as ours:
        call(pt, pds, sched)
    assert str(ours.value) == str(ref.value)


def _jax_checkpoint(tmp_path, p, optimizer):
    wkw = dict(policy="ema|boltzmann", async_mode="on_device",
               optimizer=optimizer)
    jt, jds, _, _ = _pair(p, seed=4, **wkw)
    jt.run(jds, 4)
    ck = str(tmp_path / optimizer)
    jt.save_checkpoint(ck, 6)
    jt._ckpt.wait()
    return ck, wkw


@pytest.mark.parametrize("saved,resumed", [(4, 6), (6, 4), (4, 2)])
def test_jax_checkpoint_resumed_by_the_port_at_another_p(tmp_path, saved,
                                                         resumed):
    """A JAX checkpoint at p=saved, resumed by the port and by JAX at
    p=resumed: the resumed states agree (AdamW: moments and step count
    through the resize), and a momentum run continues round by round
    with JAX's resume.

    The continued rounds use momentum, not AdamW: this AdamW run reaches
    losses near 1e-6 by its checkpoint, where the f32 cross-entropy
    gradient is rounding noise (after a bitwise-equal resume at p=6 the
    two packages' gradients differ in their third digit) and AdamW's
    normalization turns that noise into steps of order lr, far past the
    params' 1e-5. At a power-of-two p JAX's 1/p gradient scale is exact
    and the two roundings coincide."""
    ck, wkw = _jax_checkpoint(tmp_path, saved, "adamw")
    jt2, _, pt2, _ = _pair(resumed, seed=4, **wkw)
    assert pt2.resume(ck) == jt2.resume(ck) == 6
    _hold_trees(pt2.state._replace(step=0), jt2.state._replace(step=0),
                atol=1e-6)
    assert pt2.state.step == int(jt2.state.step)
    assert int(pt2.state.opt_state.count) == int(jt2.state.opt_state.count)

    ck, wkw = _jax_checkpoint(tmp_path, saved, "momentum")
    jt3, jds3, pt3, pds3 = _pair(resumed, seed=4, **wkw)
    jsnap, psnap = _run_both(jt3, jds3, pt3, pds3, 9, resume_from=ck)
    _hold_rounds(jt3, pt3, jsnap, psnap)
    assert pt3.n_workers == resumed and len(pt3.history) == 3


def test_port_checkpoint_resumed_by_jax_at_another_p(tmp_path):
    """The port's p=6 checkpoint, resumed by JAX at p=4 and by the port at
    p=4: survivors bitwise, every leaf equal to the port's own
    ``resize_train_state`` of the saved state."""
    wkw = dict(policy="ema|boltzmann", async_mode="on_device",
               optimizer="momentum")
    _, _, pt, pds = _pair(6, seed=4, **wkw)
    pt.run(pds, 3)
    ck = str(tmp_path / "ck")
    pt.save_checkpoint(ck, 3)
    pt._ckpt.wait()
    jt2, _, pt2, _ = _pair(4, seed=4, **wkw)
    assert jt2.resume(ck) == pt2.resume(ck) == 3
    expect = mem.resize_train_state(pt.state, pt.axes, 4,
                                    policy=parse_policy("ema|boltzmann"))
    _hold_trees(pt2.state, expect)
    _hold_trees(jt2.state._replace(step=0), expect._replace(step=0))
    assert int(jt2.state.step) == pt2.state.step == pt.state.step
    saved = jckpt.saved_topology(ck)["topology"]
    assert saved["p"] == 6 and saved["round"] == 3
    assert all(v.shape[0] == 4 for v in tree_leaves(pt2.state.params))
