"""The port's pipelined WASGD rounds (``repro_torch/train/step.py``,
``repro_torch/data/pipeline.py``) and the aggregate's overlap seam
(``repro_torch/core/backends.py``), case for case against
``tests/test_pipeline.py`` where a case has a one-device counterpart.

Three guarantees, as in the JAX package:

* **parity**: ``pipeline="parity"`` gives params and every round's
  metrics bitwise equal to the port's unpipelined round, step by step for
  the specs ``einsum:f32``, ``hierarchical:int8``, ``pallas_wagg:f32``
  and ``pallas_wagg:bf16``, and through ``Trainer.run`` for synchronous
  and Alg. 4 rounds;
* **speculative bound**: the seam's stale losses deviate from the next
  round's true first losses by exactly 0 at ``beta = 0``, and within the
  bound the round measures (``spec_dev <= 2 * spec_bound``) otherwise;
* **prefetch correctness**: the staged first microbatch is the slice the
  next round's ``reshape_batch`` takes, and OrderGen decides at each
  segment boundary (deferred by ``boundary_delay``).

The port's pipelined runs are also held to the JAX package's pipelined
``Trainer`` on the paper's MLP harness (``benchmarks/common.py``), from
the same JAX-initialised params carried over through numpy, with
``tests/test_torch_train.py``'s per-round tolerances: params atol 1e-5,
h and loss rtol 1e-5, theta atol 1e-6, and the seam's losses rtol 1e-5.
Everything runs on the CPU (``device="cpu"``): the kernels' plain
versions, the prefetcher without a copy.
"""
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import common  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.data import RoundPrefetcher as JRoundPrefetcher  # noqa: E402
from repro.data import first_microbatch as j_first_microbatch  # noqa: E402
from repro.data import make_classification as j_make_classification  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.param import build as j_build  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import replicate_workers  # noqa: E402
from repro_torch.core import backends  # noqa: E402
from repro_torch.data import (OrderedDataset, RoundPrefetcher,  # noqa: E402
                              first_microbatch)
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.state import init_state  # noqa: E402
from repro_torch.train.step import (build_train_step,  # noqa: E402
                                    init_comm_state, spsgd_rule)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

W = 2                  # workers (the JAX file's count on one device)


def _problem(seed=0):
    """The JAX file's problem: its MLP from JAX's init (carried over
    through numpy), its classification data."""
    X, y = j_make_classification(seed, 1024, d=16, n_classes=4)
    pj, axes = j_build(functools.partial(
        jcnn.mlp_init, d_in=16, d_hidden=32, n_classes=4),
        jax.random.key(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")

    def loss_fn(p, b):
        return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}

    return X, y, params, axes, loss_fn


def _assert_trees_bitwise(a, b, label=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), label
    for x, z in zip(la, lb):
        assert torch.equal(x, z), label


def _assert_history_bitwise(h0, h1):
    assert len(h0) == len(h1)
    for r, (a, b) in enumerate(zip(h0, h1)):
        for k in a:
            assert k in b, (r, k)
            assert np.array_equal(a[k], b[k]), (r, k, a[k], b[k])


def _on_cpu(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Prefetch correctness
# ---------------------------------------------------------------------------

def test_first_microbatch_matches_step_slice():
    """The staged slice equals reshape_batch(batch)[0] and JAX's
    first_microbatch, for numpy and tensor leaves."""
    from repro_torch.train.step import _round_parts
    p, tau, bl = 3, 4, 5
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(tau * p * bl, 7)).astype(np.float32),
             "y": rng.integers(0, 9, size=tau * p * bl)}
    first = first_microbatch(batch, p, tau)
    first_t = first_microbatch(_on_cpu(batch), p, tau)
    ref = j_first_microbatch(batch, p, tau)
    parts = _round_parts(lambda q, b: (q["w"].sum(), {}),
                         make_optimizer("sgd"), {"w": ("worker",)},
                         WASGDConfig(tau=tau), p)
    step_view = parts.reshape_batch(_on_cpu(batch))
    for k, v in batch.items():
        np.testing.assert_array_equal(first[k], np.asarray(ref[k]))
        np.testing.assert_array_equal(first_t[k].numpy(), first[k])
        np.testing.assert_array_equal(step_view[k][0].numpy(), first[k])


def test_first_microbatch_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        first_microbatch({"x": np.zeros((7, 2))}, n_workers=2, tau=2)


def test_round_prefetcher_pairs_infinite_stream():
    """(batch_r, first_{r+1}) pairs, as JAX's prefetcher yields them."""
    X, y, *_ = _problem()
    p, tau, bl = 2, 2, 4
    mk = lambda: OrderedDataset({"x": X, "y": y}, p, tau, bl, seed=7)  # noqa: E731
    raw = mk().batches()
    raws = [next(raw) for _ in range(6)]
    pf = RoundPrefetcher(mk().batches(), p, tau, device="cpu")
    jpf = JRoundPrefetcher(JOrderedDataset({"x": X, "y": y}, p, tau, bl,
                                           seed=7).batches(), p, tau)
    try:
        for r in range(5):
            batch, nf = next(pf)
            jbatch, jnf = next(jpf)
            np.testing.assert_array_equal(batch["x"].numpy(), raws[r]["x"])
            expect = first_microbatch(raws[r + 1], p, tau)
            for k in expect:
                assert nf[k].is_contiguous()
                np.testing.assert_array_equal(nf[k].numpy(), expect[k])
                np.testing.assert_array_equal(nf[k].numpy(),
                                              np.asarray(jnf[k]))
                np.testing.assert_array_equal(batch[k].numpy(),
                                              np.asarray(jbatch[k]))
    finally:
        pf.close()
        jpf.close()


def test_round_prefetcher_finite_stream_reuses_last_first():
    X, y, *_ = _problem()
    p, tau, bl = 2, 2, 4
    ds = OrderedDataset({"x": X, "y": y}, p, tau, bl, seed=3)
    gen = ds.batches()
    raws = [next(gen) for _ in range(3)]
    pf = RoundPrefetcher(iter(raws), p, tau, device="cpu")
    got = list(pf)
    pf.close()
    assert len(got) == 3
    expect = first_microbatch(raws[2], p, tau)
    for k in expect:
        np.testing.assert_array_equal(got[2][1][k].numpy(), expect[k])


def test_round_prefetcher_propagates_errors_and_closes():
    def boom():
        yield {"x": np.zeros((8, 2), np.float32)}
        raise RuntimeError("upstream died")

    pf = RoundPrefetcher(boom(), n_workers=2, tau=2, device="cpu")
    with pytest.raises(RuntimeError, match="upstream died"):
        for _ in pf:
            pass
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()                                   # again: a no-op


def test_round_prefetcher_pairs_hold_under_thread_switching():
    """200 pairs with the interpreter switching threads every microsecond:
    every pair is (round r, round r+1's first microbatch), and close
    stops the thread mid-stream."""
    p, tau = 2, 2
    rng = np.random.default_rng(4)
    raws = [{"x": rng.normal(size=(p * tau * 3, 5)).astype(np.float32),
             "y": np.full(p * tau * 3, r)} for r in range(201)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = RoundPrefetcher(iter(raws), p, tau, depth=1, device="cpu")
        for r in range(200):
            batch, nf = next(pf)
            assert int(batch["y"][0]) == r
            np.testing.assert_array_equal(
                nf["x"].numpy(), first_microbatch(raws[r + 1], p, tau)["x"])
        pf2 = RoundPrefetcher(iter(raws), p, tau, device="cpu")
        next(pf2)
        pf2.close()
        pf.close()
    finally:
        sys.setswitchinterval(old)
    assert not pf._thread.is_alive() and not pf2._thread.is_alive()


def test_round_prefetcher_resize_restarts_at_the_new_count():
    X, y, *_ = _problem()
    ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4, seed=3)
    pf = RoundPrefetcher(ds.batches(), 2, 2, device="cpu")
    try:
        next(pf)
        ds.resize(3)
        pf.resize(3, ds.batches(start_round=1))
        batch, nf = next(pf)
        assert batch["x"].shape[0] == 3 * 2 * 4
        assert nf["x"].shape[:2] == (3, 4)
        with pytest.raises(ValueError, match="n_workers >= 1"):
            pf.resize(0)
    finally:
        pf.close()


def test_entry_point_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RoundPrefetcher(iter([]), 2, 2)


# ---------------------------------------------------------------------------
# OrderGen segment boundaries (paper Alg. 2)
# ---------------------------------------------------------------------------

def _segment_ds(n_segments=2, boundary_delay=0, cls=OrderedDataset):
    data = {"x": np.arange(64, dtype=np.float32)[:, None]}
    return cls(data, n_workers=2, tau=1, b_local=4, n_segments=n_segments,
               boundary_delay=boundary_delay)
    # seg_len=32, per_round=4 -> rounds_per_segment=8


def test_ordergen_reshuffles_bad_segment_mid_epoch():
    ds = _segment_ds()
    it = ds.batches()
    seeds0 = ds.order.seeds.copy()
    for _ in range(ds.rounds_per_segment):
        next(it)
    ds.order.record_scores(0, np.array([5.0, 5.0]))
    next(it)
    assert not np.array_equal(ds.order.seeds[0], seeds0[0])
    np.testing.assert_array_equal(ds.order.seeds[1], seeds0[1])
    np.testing.assert_array_equal(ds.order.scores[0], 0.0)


def test_ordergen_keeps_good_segment_mid_epoch():
    ds = _segment_ds()
    it = ds.batches()
    seeds0 = ds.order.seeds.copy()
    for _ in range(ds.rounds_per_segment):
        next(it)
    ds.order.record_scores(0, np.array([-5.0, -5.0]))
    next(it)
    np.testing.assert_array_equal(ds.order.seeds[0], seeds0[0])


def test_ordergen_each_segment_ends_at_its_own_boundary():
    ds = _segment_ds(n_segments=2)
    it = ds.batches()
    seeds0 = ds.order.seeds.copy()
    for r in range(2 * ds.rounds_per_segment + 1):
        ds.order.record_scores(ds.segment_of_round(r), np.array([9.0, 9.0]))
        next(it)
    assert not np.array_equal(ds.order.seeds[0], seeds0[0])
    assert not np.array_equal(ds.order.seeds[1], seeds0[1])


def test_ordergen_boundary_delay_defers_decision():
    ds = _segment_ds(boundary_delay=1)
    it = ds.batches()
    seeds0 = ds.order.seeds.copy()
    for _ in range(ds.rounds_per_segment):
        next(it)
    ds.order.record_scores(0, np.array([5.0, 5.0]))
    next(it)                                     # boundary round: deferred
    np.testing.assert_array_equal(ds.order.seeds[0], seeds0[0])
    next(it)                                     # +1 round: decision fires
    assert not np.array_equal(ds.order.seeds[0], seeds0[0])


def test_ordergen_deferred_decision_never_fires_mid_traversal():
    ds = _segment_ds(n_segments=1, boundary_delay=2)
    rps = ds.rounds_per_segment
    it = ds.batches()
    seeds0 = ds.order.seeds.copy()
    for _ in range(rps):
        next(it)
    ds.order.record_scores(0, np.array([9.0, 9.0]))
    for _ in range(rps):
        next(it)
        np.testing.assert_array_equal(ds.order.seeds[0], seeds0[0])
    next(it)
    assert not np.array_equal(ds.order.seeds[0], seeds0[0])


@pytest.mark.parametrize("n_segments, delay", [(2, 0), (2, 1), (2, 4),
                                               (1, 2), (1, 9)])
def test_ordergen_decisions_are_the_jax_packages(n_segments, delay):
    """The same seeded scores through both datasets: the same batches and
    the same seeds, round by round, across deferred decisions."""
    ours = _segment_ds(n_segments, delay)
    ref = _segment_ds(n_segments, delay, cls=JOrderedDataset)
    assert ours.rounds_per_epoch == ref.rounds_per_epoch
    go, gr = ours.batches(), ref.batches()
    rng = np.random.default_rng(n_segments * 10 + delay)
    for r in range(40):
        np.testing.assert_array_equal(next(go)["x"], next(gr)["x"])
        s = rng.normal(scale=2.0, size=2)
        ours.order.record_scores(ours.segment_of_round(r), s)
        ref.order.record_scores(ref.segment_of_round(r), s)
        np.testing.assert_array_equal(ours.order.seeds, ref.order.seeds)


# ---------------------------------------------------------------------------
# The overlap seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec, n_pods", [("einsum:f32", 1),
                                          ("hierarchical:int8", 2),
                                          ("pallas_wagg:f32", 1),
                                          ("pallas_wagg:int4", 1)])
def test_overlap_seam_leaves_params_and_runs_between_phases(spec, n_pods):
    """With a thunk the aggregate is bitwise the thunk-free one, returns
    the thunk's tree, and runs it after every leaf's phase 0 and before
    any later phase or finalize (a leaf handed to ``pallas_wagg``'s
    grouped ``finalize_many`` counts as its finalize)."""
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.normal(size=(4, 6)).astype(
                  np.float32)),
              "b": {"c": torch.from_numpy(rng.normal(size=(4, 3, 2)).astype(
                  np.float32))},
              "s": torch.ones(5)}
    axes = {"a": ("worker", None), "b": {"c": ("worker", None, None)},
            "s": (None,)}
    theta = torch.tensor([0.1, 0.2, 0.3, 0.4])
    ctx = backends.AggregationContext(n_pods=n_pods)
    backend = backends.get_backend(spec)
    ref = backend.aggregate(params, axes, theta, 0.9, ctx=ctx)
    sched, log = backend.schedule, []
    real = sched.reduce_phase, sched.finalize

    def reduce_phase(i, *a):
        log.append(("reduce", i))
        return real[0](i, *a)

    def finalize(*a):
        log.append(("finalize",))
        return real[1](*a)

    sched.reduce_phase, sched.finalize = reduce_phase, finalize
    real_many = getattr(sched, "finalize_many", None)
    if real_many is not None:
        def finalize_many(states, xs, *a):
            log.extend([("finalize",)] * len(xs))
            return real_many(states, xs, *a)

        sched.finalize_many = finalize_many
    try:
        out, seam = backend.aggregate(
            params, axes, theta, 0.9, ctx=ctx,
            overlap=lambda: log.append(("seam",)) or {"t": torch.ones(2)})
    finally:
        del sched.reduce_phase, sched.finalize
        if real_many is not None:
            del sched.finalize_many
    _assert_trees_bitwise(ref, out, spec)
    assert torch.equal(seam["t"], torch.ones(2))
    cut = log.index(("seam",))
    assert log[:cut] == [("reduce", 0)] * 2
    assert all(e != ("reduce", 0) for e in log[cut + 1:])
    assert log[cut + 1:].count(("finalize",)) == 2
    assert len(log[cut + 1:]) == 2 * sched.n_phases


# ---------------------------------------------------------------------------
# Parity mode: bitwise the unpipelined round
# ---------------------------------------------------------------------------

SPECS = ["einsum:f32", "hierarchical:int8", "pallas_wagg:f32",
         "pallas_wagg:bf16"]


def _steps_for(spec, pipeline, loss_fn, axes, n_workers, tau=2, n_pods=1):
    wcfg = WASGDConfig(tau=tau, backend=spec, n_pods=n_pods)
    opt = make_optimizer("sgd", 0.05, 0.0, 0.0)
    step = build_train_step(loss_fn, opt, axes, wcfg, n_workers,
                            pipeline=pipeline)
    return wcfg, opt, step


@pytest.mark.parametrize("spec", SPECS)
def test_pipeline_parity_bitwise_per_spec(spec):
    """Step-level parity: identical params and metrics several rounds deep
    (the carried seam output is the next round's t = 0 microbatch)."""
    X, y, params0, axes0, loss_fn = _problem()
    w, tau, bl = W, 2, 4
    params, axes = replicate_workers(params0, axes0, w)
    n_pods = 2 if spec.startswith("hierarchical") else 1
    wcfg, opt, step0 = _steps_for(spec, None, loss_fn, axes, w, tau,
                                  n_pods=n_pods)
    _, _, step1 = _steps_for(spec, "parity", loss_fn, axes, w, tau,
                             n_pods=n_pods)
    ds = OrderedDataset({"x": X, "y": y}, w, tau, bl, seed=11)
    gen = ds.batches()
    raws = [next(gen) for _ in range(4)]
    comm = init_comm_state("wasgd", params, axes, w, wcfg=wcfg)
    copy = lambda t: tree_map(torch.clone, t)  # noqa: E731
    s0 = init_state(copy(params), opt.init(params), w, comm)
    s1 = init_state(copy(params), opt.init(params), w, comm)
    carry = step1.primer(s1.params, _on_cpu(raws[0]))
    for r in range(3):
        nf = _on_cpu(first_microbatch(raws[r + 1], w, tau))
        s0, m0 = step0(s0, _on_cpu(raws[r]))
        s1, m1, carry = step1(s1, _on_cpu(raws[r]), nf, carry)
        for k in m0:
            assert torch.equal(m0[k], m1[k]), (spec, r, k)
        _assert_trees_bitwise(s0.params, s1.params, (spec, r))
        _assert_trees_bitwise(carry["first"], nf, (spec, r, "staged"))


def _trainer_run(pipeline, wcfg, rounds, seed=5, tau=2, bl=4, **kw):
    X, y, params, axes, loss_fn = _problem()
    tr = Trainer(loss_fn, params, axes,
                 TrainConfig(learning_rate=0.05, wasgd=wcfg), W,
                 device="cpu", pipeline=pipeline)
    ds = OrderedDataset({"x": X, "y": y}, W, tau, bl, seed=seed)
    tr.run(ds.batches(), rounds, **kw)
    return tr


def test_pipeline_parity_through_trainer_run():
    wcfg = WASGDConfig(tau=2, backend="pallas_wagg:f32")
    t0, t1 = (_trainer_run(p, wcfg, 5) for p in (None, "parity"))
    _assert_history_bitwise(t0.history, t1.history)
    _assert_trees_bitwise(t0.state.params, t1.state.params)


def test_pipeline_parity_async_on_device_through_trainer_run():
    """Alg. 4 rounds: the mask rides comm_state, the seam the masked
    aggregate; parity stays bitwise."""
    rounds, w = 5, 3
    sched = np.ones((rounds, w), bool)
    rng = np.random.default_rng(2)
    for r in range(1, rounds):
        sched[r, rng.choice(w, 1)] = False
    X, y, params, axes, loss_fn = _problem()
    tcfg = TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(
        tau=2, backend="pallas_wagg:f32", async_mode="on_device"))

    def run(pipeline):
        tr = Trainer(loss_fn, params, axes, tcfg, w, device="cpu",
                     pipeline=pipeline)
        ds = OrderedDataset({"x": X, "y": y}, w, 2, 4, seed=5)
        tr.run(ds.batches(), rounds, straggler_schedule=sched)
        return tr

    t0, t1 = run(None), run("parity")
    _assert_history_bitwise(t0.history, t1.history)
    _assert_trees_bitwise(t0.state.params, t1.state.params)
    assert [h["active"].tolist() for h in t1.history] == \
        sched.astype(np.float32).tolist()


# ---------------------------------------------------------------------------
# Speculative mode: the stale Judge forward and its measured bound
# ---------------------------------------------------------------------------

def test_speculative_beta0_deviation_exactly_zero():
    wcfg = WASGDConfig(tau=2, beta=0.0, backend="pallas_wagg:f32")
    t1, t2 = (_trainer_run(p, wcfg, 5, seed=9)
              for p in ("parity", "speculative"))
    for h in t2.history:
        assert float(np.abs(h["spec_dev"]).max()) == 0.0
    _assert_trees_bitwise(t1.state.params, t2.state.params)
    for a, b in zip(t1.history, t2.history):
        np.testing.assert_array_equal(a["h"], b["h"])
        np.testing.assert_array_equal(a["theta"], b["theta"])


def test_speculative_deviation_within_measured_bound():
    """|spec - true|_i <= 2 ||grad L_i(t=0)|| ||delta x_i|| (the 2x slack
    for the endpoint-gradient surrogate); round 0's deviation is 0."""
    wcfg = WASGDConfig(tau=2, beta=0.5, backend="pallas_wagg:f32")
    tr = _trainer_run("speculative", wcfg, 8, seed=9)
    assert float(tr.history[0]["spec_dev"].max()) == 0.0
    devs = np.stack([h["spec_dev"] for h in tr.history[1:]])
    bounds = np.stack([h["spec_bound"] for h in tr.history[1:]])
    assert np.isfinite(devs).all() and (devs > 0).any()
    assert (devs <= 2.0 * bounds + 1e-6).all(), \
        (devs.max(), bounds[devs > 2.0 * bounds].min())


def test_speculative_trains():
    tr = _trainer_run("speculative", WASGDConfig(tau=4), 12, seed=1, tau=4,
                      bl=8)
    losses = tr.losses()
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# Against the JAX package's pipelined Trainer (the MLP harness)
# ---------------------------------------------------------------------------

P, TAU, B_LOCAL, N_SAMPLES = 4, 8, 8, 512


def _harness_run(framework, pipeline, rounds, beta=0.9):
    params_j, axes, loss_j, _ = common.model(0, False)
    X, y = common.dataset(0, False)
    data = {"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}
    wkw = dict(tau=TAU, beta=beta, a_tilde=1.0, strategy="boltzmann",
               backend="pallas_wagg:f32")
    delay = RoundPrefetcher.run_ahead()
    if framework == "jax":
        tr = JTrainer(loss_j, params_j, axes,
                      JTrainConfig(learning_rate=0.05, optimizer="sgd",
                                   wasgd=JWASGDConfig(**wkw)), P,
                      rule="wasgd+", pipeline=pipeline)
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7,
                             boundary_delay=delay)
    else:
        start = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                  device="cpu")
        tr = Trainer(lambda p, b: (classification_loss(
                         mlp_apply(p, b["x"]), b["y"]), {}), start, axes,
                     TrainConfig(learning_rate=0.05, optimizer="sgd",
                                 wasgd=WASGDConfig(**wkw)), P,
                     rule="wasgd+", device="cpu", pipeline=pipeline)
        ds = OrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7,
                            boundary_delay=delay)
    tr.run(ds, rounds)
    return tr, ds


@pytest.mark.parametrize("pipeline", ["parity", "speculative"])
def test_pipelined_trainer_matches_jax_round_by_round(pipeline):
    """10 rounds of the MLP harness through both packages' pipelined
    Trainers; segment 0's OrderGen decision, deferred by boundary_delay
    = run_ahead() = 4, fires at round 8 (the seeds must agree after it)."""
    rounds = 10
    tr_j, ds_j = _harness_run("jax", pipeline, rounds)
    tr_t, ds_t = _harness_run("port", pipeline, rounds)
    for r, (hj, ht) in enumerate(zip(tr_j.history, tr_t.history)):
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
        if pipeline == "speculative":
            np.testing.assert_allclose(ht["spec_losses"], hj["spec_losses"],
                                       rtol=1e-5, err_msg=f"round {r}")
            assert (ht["spec_dev"] <= 2 * ht["spec_bound"] + 1e-6).all()
    pj = jax.tree.map(np.asarray, tr_j.state.params)
    for k, v in tr_t.state.params.items():
        np.testing.assert_allclose(v.numpy(), pj[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(ds_t.order.seeds, ds_j.order.seeds)
    assert len(tr_t.history) == rounds


# ---------------------------------------------------------------------------
# Refusals: JAX's errors, JAX's messages
# ---------------------------------------------------------------------------

def test_pipeline_rejects_unknown_mode_and_overlap_combo():
    _, _, params0, axes0, loss_fn = _problem()
    params, axes = replicate_workers(params0, axes0, 2)
    opt = make_optimizer("sgd", 0.05, 0.0, 0.0)
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        build_train_step(loss_fn, opt, axes, WASGDConfig(), 2,
                         pipeline="warp")
    with pytest.raises(ValueError, match="seam"):
        build_train_step(loss_fn, opt, axes, WASGDConfig(), 2,
                         pipeline="parity", overlap=lambda: torch.ones(()))


def test_pipeline_rejects_rule_without_overlap_seam():
    _, _, params0, axes0, loss_fn = _problem()
    params, axes = replicate_workers(params0, axes0, 2)
    opt = make_optimizer("sgd", 0.05, 0.0, 0.0)
    with pytest.raises(ValueError, match="overlap"):
        build_train_step(loss_fn, opt, axes, WASGDConfig(), 2,
                         rule=spsgd_rule(), pipeline="parity")


def test_trainer_rejects_pipeline_for_baseline_rules():
    _, _, params, axes, loss_fn = _problem()
    tcfg = TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(tau=2))
    with pytest.raises(ValueError, match="wasgd"):
        Trainer(loss_fn, params, axes, tcfg, 2, rule="spsgd",
                pipeline="parity", device="cpu")


@pytest.mark.parametrize("case", ["unknown_mode", "overlap_combo",
                                  "rule_without_seam", "baseline_rule"])
def test_refusals_carry_the_jax_packages_messages(case):
    """Each refusal raises what JAX's raises, with the same message."""
    from repro.core import replicate_workers as j_replicate
    from repro.optim import make_optimizer as j_make_optimizer
    from repro.train.step import build_train_step as j_build_step
    from repro.train.step import spsgd_rule as j_spsgd_rule
    X, y, params0, axes0, loss_fn = _problem()
    pj, axes_j = j_build(functools.partial(
        jcnn.mlp_init, d_in=16, d_hidden=32, n_classes=4),
        jax.random.key(0))
    params, axes = replicate_workers(params0, axes0, 2)
    _, axes_jw = j_replicate(pj, axes_j, 2)
    opt, jopt = make_optimizer("sgd", 0.05), j_make_optimizer("sgd", 0.05)
    calls = {
        "unknown_mode": (
            lambda: build_train_step(loss_fn, opt, axes, WASGDConfig(), 2,
                                     pipeline="warp"),
            lambda: j_build_step(None, jopt, axes_jw, JWASGDConfig(), 2,
                                 pipeline="warp")),
        "overlap_combo": (
            lambda: build_train_step(loss_fn, opt, axes, WASGDConfig(), 2,
                                     pipeline="parity",
                                     overlap=lambda: None),
            lambda: j_build_step(None, jopt, axes_jw, JWASGDConfig(), 2,
                                 pipeline="parity", overlap=lambda: None)),
        "rule_without_seam": (
            lambda: build_train_step(loss_fn, opt, axes, WASGDConfig(), 2,
                                     rule=spsgd_rule(), pipeline="parity"),
            lambda: j_build_step(None, jopt, axes_jw, JWASGDConfig(), 2,
                                 rule=j_spsgd_rule(), pipeline="parity")),
        "baseline_rule": (
            lambda: Trainer(loss_fn, params0, axes0, TrainConfig(), 2,
                            rule="seq", pipeline="speculative",
                            device="cpu"),
            lambda: JTrainer(None, pj, axes_j, JTrainConfig(), 2,
                             rule="seq", pipeline="speculative")),
    }
    ours, ref = calls[case]
    with pytest.raises(ValueError) as e_ref:
        ref()
    with pytest.raises(ValueError) as e_ours:
        ours()
    assert str(e_ours.value) == str(e_ref.value)


# ---------------------------------------------------------------------------
# Trainer <-> OrderedDataset coordination under prefetch
# ---------------------------------------------------------------------------

def _small_trainer(pipeline="parity"):
    X, y, params, axes, loss_fn = _problem()
    tcfg = TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(tau=2))
    return X, y, Trainer(loss_fn, params, axes, tcfg, 2, device="cpu",
                         pipeline=pipeline)


def test_pipelined_run_validates_dataset_boundary_delay():
    X, y, tr = _small_trainer()
    ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4, n_segments=2, seed=3)
    with pytest.raises(ValueError, match="boundary_delay"):
        tr.run(ds, 4)


def test_pipelined_run_accepts_dataset_and_defaults_order_state():
    X, y, tr = _small_trainer()
    ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4, n_segments=2, seed=3,
                        boundary_delay=RoundPrefetcher.run_ahead())
    tr.run(ds, 4)
    assert len(tr.history) == 4
    assert np.abs(ds.order.scores).sum() > 0


def test_pipelined_run_warns_on_bare_iterator_with_order_state():
    X, y, tr = _small_trainer()
    ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4, n_segments=2, seed=3)
    with pytest.warns(UserWarning, match="run-ahead"):
        tr.run(ds.batches(), 3, order_state=ds.order,
               segment_fn=ds.segment_of_round)


def test_unpipelined_run_accepts_dataset():
    X, y, tr = _small_trainer(pipeline=None)
    ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4, n_segments=2, seed=3)
    tr.run(ds, 4)
    assert len(tr.history) == 4
    assert np.abs(ds.order.scores).sum() > 0


def test_pipelined_elastic_run_reprimes_at_each_resize():
    """A membership resize restarts the prefetcher at the new count and
    re-primes the seam; the run is bitwise the unpipelined elastic run."""
    from repro_torch.core.membership import MembershipSchedule

    def run(pipeline):
        X, y, params, axes, loss_fn = _problem()
        tr = Trainer(loss_fn, params, axes,
                     TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(
                         tau=2, backend="pallas_wagg:f32")), 2,
                     device="cpu", pipeline=pipeline)
        ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4, seed=3,
                            boundary_delay=RoundPrefetcher.run_ahead())
        tr.run(ds, 6, membership_schedule=MembershipSchedule(2, {2: 3,
                                                                 4: 2}))
        return tr

    t0, t1 = run(None), run("parity")
    assert [int(h["p"]) for h in t1.history] == [2, 2, 3, 3, 2, 2]
    _assert_history_bitwise(t0.history, t1.history)
    _assert_trees_bitwise(t0.state.params, t1.state.params)
