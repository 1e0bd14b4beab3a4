"""The port's WASGD core (``repro_torch.core``) against the JAX package, on
the same numpy inputs: configs, energies, the Judge and OrderGen, every
worker-assessment policy stage, the payload codecs, Eq. 10 and the
``schedule:codec`` aggregation specs.

Tolerances. Float32 results: atol 1e-6 (values of order one, summation
order only). Policies: atol 1e-6 on theta (softmax of the same float32
logits). bf16 specs: each aggregate within the codec's documented
``error_bound`` of JAX's (the two round bfloat16 sums in other orders).
Codec payloads (int8 codes, bf16 casts) and OrderGen decisions: exact.
Energies are drawn unique after the float32 cast, so ties break the same
way in both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import backends as jbk  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import order as jorder  # noqa: E402
from repro.core import wasgd as jwasgd  # noqa: E402
from repro.core import weights as jweights  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.core import aggregate as tagg  # noqa: E402
from repro_torch.core import backends as tbk  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import order as torder  # noqa: E402
from repro_torch.core import wasgd as twasgd  # noqa: E402
from repro_torch.core import weights as tweights  # noqa: E402
from repro_torch.train import wasgd_rule  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from test_torch_mesh import jmesh1, world1  # noqa: E402

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _energies(rng, p):
    """Positive energies, unique after the float32 cast."""
    while True:
        h = rng.uniform(0.5, 3.0, size=p).astype(np.float32)
        if len(np.unique(h)) == p:
            return h


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["WASGDConfig", "TrainConfig"])
def test_configs_have_the_jax_fields_and_defaults(name):
    ours, ref = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("kw", [
    {"strategy": "nope"},
    # reprolint: allow=SPEC001 -- error path: an unknown stage
    {"policy": "boltzmann|unknown"},
    # reprolint: allow=SPEC001 -- error path: an out-of-range argument
    {"policy": "ema(decay=2)"},
    # reprolint: allow=SPEC001 -- error path: a modifier without an 'a'
    {"policy": "inverse|anneal"}])
def test_wasgd_config_rejects_bad_policies_like_jax(kw):
    with pytest.raises(ValueError):
        jcfg.WASGDConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.WASGDConfig(**kw)


# ---------------------------------------------------------------------------
# energy, Judge, OrderGen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [1, 4, 8, 13])
@pytest.mark.parametrize("m,c", [(1, 1), (100, 4), (3, 2), (8, 8)])
def test_record_mask_matches_jax(tau, m, c):
    np.testing.assert_array_equal(tenergy.record_indices(tau, m, c),
                                  jenergy.record_indices(tau, m, c))
    np.testing.assert_array_equal(tenergy.record_mask(tau, m, c),
                                  np.asarray(jenergy.record_mask(tau, m, c)))


@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_judge_scores_match_jax(p):
    h = _energies(np.random.default_rng(p), p)
    np.testing.assert_allclose(_np(torder.judge_scores(_t(h))),
                               jorder.judge_scores(jnp.asarray(h)),
                               rtol=0, atol=ATOL)


def test_order_state_and_grouped_order_match_jax():
    ours, ref = torder.OrderState(4, 3, 9), jorder.OrderState(4, 3, 9)
    np.testing.assert_array_equal(ours.seeds, ref.seeds)
    rng = np.random.default_rng(0)
    for seg in (0, 2, 0, 1):
        s = rng.normal(size=4)
        ours.record_scores(seg, s)
        ref.record_scores(seg, s)
        np.testing.assert_array_equal(ours.end_segment(seg),
                                      ref.end_segment(seg))
        np.testing.assert_array_equal(ours.seeds, ref.seeds)
    np.testing.assert_array_equal(ours.order_for(1, 2, 50),
                                  ref.order_for(1, 2, 50))
    labels = rng.integers(0, 5, size=60)
    np.testing.assert_array_equal(torder.grouped_order(labels, 4, 3),
                                  jorder.grouped_order(labels, 4, 3))


# ---------------------------------------------------------------------------
# worker assessment
# ---------------------------------------------------------------------------

POLICY_SPECS = ["boltzmann", "boltzmann(a=8)", "inverse", "equal", "best",
                "topk(2)", "trimmed(1)", "trimmed(1)|boltzmann(a=4)",
                "ema(0.9)", "ema(0.5)|inverse", "time_aware",
                "boltzmann(a=2)|anneal(cosine, period=4, peak=10)",
                "anneal(exp, rate=0.3)", "topk(3)|ema(0.7)|best"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("spec", POLICY_SPECS)
def test_policy_matches_jax_over_rounds(spec, masked):
    """Three rounds with the state threaded through (time_aware observes
    round times between rounds)."""
    p = 6
    rng = np.random.default_rng(len(spec) + masked)
    ours, ref = tweights.parse_policy(spec, 2.0), \
        jweights.parse_policy(spec, 2.0)
    assert ours.stateful == ref.stateful
    st_o, st_r = None, None
    for _ in range(3):
        h = _energies(rng, p)
        act = None
        if masked:
            act = np.array([True, False, True, True, False, True])
        th_o, st_o = ours(_t(h), None if act is None else _t(act), st_o)
        th_r, st_r = ref(jnp.asarray(h),
                         None if act is None else jnp.asarray(act), st_r)
        np.testing.assert_allclose(_np(th_o), th_r, rtol=0, atol=ATOL)
        times = rng.uniform(0.5, 2.0, size=p).astype(np.float32)
        st_o = ours.observe_times(st_o, times)
        st_r = ref.observe_times(st_r, times)
    flat_r = jax.tree.leaves(st_r)
    flat_o = _leaves(st_o) if st_o else []
    assert len(flat_o) == len(flat_r)
    for a, b in zip(flat_o, flat_r):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("spec", ["boltzmann(a=4)", "inverse", "equal",
                                  "best", "topk(2)", "trimmed(1)",
                                  "trimmed(1)|best"])
def test_policy_is_permutation_equivariant_on_f32_unique_energies(spec):
    """theta(h[perm]) == theta(h)[perm] for energies unique after the
    float32 cast (energies unique only in float64 tie in float32 and break
    by index, which no permutation preserves)."""
    pol = tweights.parse_policy(spec)
    rng = np.random.default_rng(13)
    for _ in range(20):
        h = _energies(rng, 7)
        perm = rng.permutation(7)
        th, _ = pol(_t(h))
        th_perm, _ = pol(_t(h[perm]))
        np.testing.assert_allclose(_np(th_perm), _np(th)[perm], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"strategy": "inverse"},
                                {"strategy": "best"},
                                {"a_tilde": 5.0, "a_schedule": "anneal"},
                                {"strategy": "equal", "a_schedule": "anneal"},
                                {"policy": "ema(0.8)|boltzmann"}])
def test_legacy_aliases_resolve_like_jax(kw):
    ours = tweights.policy_from_config(tcfg.WASGDConfig(**kw))
    ref = jweights.policy_from_config(jcfg.WASGDConfig(**kw))
    assert ours.spec == ref.spec and ours.a == ref.a
    h = _energies(np.random.default_rng(1), 5)
    st_o, st_r = None, None
    for _ in range(2):
        th_o, st_o = ours(_t(h), None, st_o)
        th_r, st_r = ref(jnp.asarray(h), None, st_r)
        np.testing.assert_allclose(_np(th_o), th_r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("strategy", ["boltzmann", "inverse", "equal", "best"])
def test_stateless_entry_points_and_diagnostics_match_jax(strategy):
    h = _energies(np.random.default_rng(3), 7)
    act = np.array([True, True, False, True, False, False, True])
    th_o = tweights.compute_theta(_t(h), strategy, 3.0)
    th_r = jweights.compute_theta(jnp.asarray(h), strategy, 3.0)
    np.testing.assert_allclose(_np(th_o), th_r, rtol=0, atol=ATOL)
    mth_o = tweights.masked_compute_theta(_t(h), _t(act), 3.0, strategy)
    mth_r = jweights.masked_compute_theta(jnp.asarray(h), jnp.asarray(act),
                                          3.0, strategy)
    np.testing.assert_allclose(_np(mth_o), mth_r, rtol=0, atol=ATOL)
    assert np.all(_np(mth_o)[~act] == 0)
    for fn in ("theta_entropy", "omega"):
        np.testing.assert_allclose(
            _np(getattr(tweights, fn)(th_o)),
            getattr(jweights, fn)(th_r), rtol=0, atol=ATOL)


def test_all_false_mask_raises_like_jax():
    h, act = np.ones(3, np.float32), np.zeros(3, bool)
    with pytest.raises(ValueError, match="no active worker"):
        jweights.masked_compute_theta(jnp.asarray(h), jnp.asarray(act))
    with pytest.raises(ValueError, match="no active worker"):
        tweights.masked_compute_theta(_t(h), _t(act))


def test_best_breaks_ties_to_the_first_index_like_jax():
    h = np.array([2.0, 1.0, 3.0, 1.0], np.float32)
    for spec in ("best", "topk(1)"):
        th_o, _ = tweights.parse_policy(spec)(_t(h))
        th_r, _ = jweights.parse_policy(spec)(jnp.asarray(h))
        np.testing.assert_allclose(_np(th_o), th_r, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codecs_match_jax(codec, dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 33)) * 2.5).astype(np.float32)
    xt, xj = _t(x).to(getattr(torch, dtype)), \
        jnp.asarray(x, getattr(jnp, dtype))
    theta = rng.dirichlet(np.ones(4)).astype(np.float32)
    ours, ref = tcodecs.get_codec(codec), jcodecs.get_codec(codec)
    assert (ours.name, ours.quantizing) == (ref.name, ref.quantizing)
    q_o, aux_o = ours.encode(xt)
    q_r, aux_r = ref.encode(xj)
    assert str(q_o.dtype).split(".")[1] == str(q_r.dtype)
    np.testing.assert_array_equal(_np(q_o), np.asarray(q_r, np.float32))
    assert (aux_o is None) == (aux_r is None)
    if aux_o is not None:
        np.testing.assert_array_equal(_np(aux_o), np.asarray(aux_r,
                                                             np.float32))
    m = rng.normal(size=33).astype(np.float32)
    np.testing.assert_allclose(
        _np(ours.decode_reduced(_t(m), aux_o)),
        ref.decode_reduced(jnp.asarray(m), aux_r), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        _np(ours.error_bound(xt, _t(theta), 0.9)),
        ref.error_bound(xj, jnp.asarray(theta), 0.9), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Eq. 10 and the aggregation specs
# ---------------------------------------------------------------------------

def _tree(p=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": (rng.normal(size=(p, 5, 3)) * 2).astype(np.float32),
              "blk": {"w": rng.normal(size=(p, 17)).astype(np.float32),
                      "shared": rng.normal(size=(6,)).astype(np.float32)}}
    axes = {"a": ("worker", None, None),
            "blk": {"w": ("worker", "embed"), "shared": ("embed",)}}
    return params, axes


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [x for k in sorted(tree) for x in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("sched", ["einsum", "hierarchical", "pallas_wagg"])
def test_composed_backends_match_jax(sched, codec, masked):
    params, axes = _tree()
    theta = np.random.default_rng(2).dirichlet(np.ones(4)).astype(np.float32)
    act = np.array([True, False, True, True]) if masked else None
    spec = f"{sched}:{codec}"
    ctx_o = tbk.AggregationContext(n_pods=2, active=None if act is None
                                   else _t(act))
    ctx_r = jbk.AggregationContext(n_pods=2, active=None if act is None
                                   else jnp.asarray(act))
    ours = tbk.aggregate_with(spec, _tmap(_t, params), axes, _t(theta), 0.9,
                              ctx=ctx_o)
    ref = jbk.aggregate_with(spec, _tmap(jnp.asarray, params), axes,
                             jnp.asarray(theta), 0.9, ctx=ctx_r)
    bound_codec = jcodecs.get_codec(codec)
    for (o, r, x) in zip(_leaves(ours), _leaves(ref), _leaves(params)):
        tol = ATOL if codec != "bf16" else float(bound_codec.error_bound(
            jnp.asarray(x), jnp.asarray(theta), 0.9))
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(ours["blk"]["shared"]),
                                  params["blk"]["shared"])


@pytest.mark.parametrize("kw, spec", [
    ({}, "einsum"), ({"quantize_comm": True}, "einsum:int8"),
    ({"hierarchical": True, "n_pods": 2}, "hierarchical"),
    ({"hierarchical": True, "n_pods": 2, "quantize_comm": True},
     "hierarchical:int8"),
    ({"backend": "pallas_wagg"}, "pallas_wagg"),
    ({"backend": "quantized"}, "quantized")])
def test_backend_names_and_aliases_resolve_like_jax(kw, spec):
    ours = tbk.backend_name_from_config(tcfg.WASGDConfig(**kw))
    ref = jbk.backend_name_from_config(jcfg.WASGDConfig(**kw))
    assert ours == ref == spec
    assert tbk.resolve_spec(spec) == jbk.resolve_spec(spec)


@pytest.mark.parametrize("spec", ["shard_map", "rs_ag", "auto", "rs_ag:int8",
                                  "shard_map:f32", "async_rs_ag"])
def test_mesh_specs_are_not_ported_and_say_so(spec, tmp_path):
    """The mesh specs are ported now (the test keeps its name and cases):
    without a mesh each raises JAX's error (``"auto"`` is resolved per
    tree, so ``get_backend`` refuses it and the rule builds, as in JAX);
    under a one-rank gloo mesh the rule runs and matches JAX's on a
    one-device mesh."""
    params, axes = _tree()
    h = _energies(np.random.default_rng(5), 4)
    tw, jw = tcfg.WASGDConfig(backend=spec), jcfg.WASGDConfig(backend=spec)
    if spec == "auto":
        for bk in (tbk, jbk):
            with pytest.raises(KeyError, match="resolved per parameter tree"):
                bk.get_backend(spec)
    else:
        assert tbk.canonical_spec(spec) == jbk.canonical_spec(spec)
        with pytest.raises(ValueError, match="needs a mesh"):
            wasgd_rule(tw)
        with pytest.raises(ValueError, match="needs a mesh"):
            jstep.wasgd_rule(jw)
    with world1(tmp_path / "store") as mesh:
        ours, _, theta_o, _ = wasgd_rule(tw, mesh=mesh)(
            _tmap(_t, params), axes, _t(h), ())
    ref, _, theta_r, _ = jstep.wasgd_rule(jw, mesh=jmesh1())(
        _tmap(jnp.asarray, params), axes, jnp.asarray(h), ())
    np.testing.assert_allclose(_np(theta_o), np.asarray(theta_r), atol=ATOL)
    for o, r in zip(_leaves(ours), _leaves(ref)):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0,
                                   atol=ATOL * max(1.0, float(np.abs(
                                       np.asarray(r)).max())))


def test_unknown_specs_and_degenerate_pods_raise():
    with pytest.raises(KeyError, match="unknown"):
        # reprolint: allow=SPEC001 -- error path: an unknown codec
        tbk.resolve_spec("einsum:fp7")
    with pytest.raises(KeyError, match="unknown"):
        tbk.resolve_spec("nowhere")
    params, axes = _tree(p=3)
    with pytest.raises(ValueError, match="n_pods"):
        tbk.aggregate_with("hierarchical:f32", _tmap(_t, params), axes,
                           torch.full((3,), 1 / 3), 0.9,
                           ctx=tbk.AggregationContext(n_pods=2))
    with pytest.raises(ValueError, match="n_pods"):
        tbk.backend_name_from_config(tcfg.WASGDConfig(hierarchical=True))


def test_aggregate_helpers_match_jax():
    params, axes = _tree(seed=5)
    theta = np.random.default_rng(6).dirichlet(np.ones(4)).astype(np.float32)
    act = np.array([False, True, True, False])
    pt, pj = _tmap(_t, params), _tmap(jnp.asarray, params)
    # Eq. 10 with the float32 leaf, and the late-join FMA
    for o, r in zip(_leaves(tagg.weighted_aggregate(pt, axes, _t(theta),
                                                    0.6)),
                    _leaves(jagg.weighted_aggregate(pj, axes,
                                                    jnp.asarray(theta),
                                                    0.6))):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0, atol=ATOL)
    m = np.random.default_rng(7).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tagg.fma_late_join(pt["a"], _t(m), 0.6, _t(act))),
        jagg.fma_late_join(pj["a"], jnp.asarray(m), 0.6, jnp.asarray(act)),
        rtol=0, atol=ATOL)
    assert tagg.worker_in_axes(axes) == jagg.worker_in_axes(axes)
    for o, r in zip(_leaves(tagg.take_worker(pt, axes, 2)),
                    _leaves(jagg.take_worker(pj, axes, 2))):
        np.testing.assert_array_equal(_np(o), np.asarray(r))
    doubled = tagg.map_worker_leaves(lambda x: 2 * x, pt, axes)
    np.testing.assert_array_equal(_np(doubled["a"]), 2 * params["a"])
    single = tagg.take_worker(pt, axes, 0)
    single_axes = {"a": (None, None), "blk": {"w": ("embed",),
                                              "shared": ("experts",)}}
    rep_o, ax_o = tagg.replicate_workers(single, single_axes, 3)
    rep_r, ax_r = jagg.replicate_workers(
        _tmap(lambda v: jnp.asarray(v.numpy()), single), single_axes, 3)
    assert ax_o == ax_r
    for o, r in zip(_leaves(rep_o), _leaves(rep_r)):
        np.testing.assert_array_equal(_np(o), np.asarray(r))
        assert o.is_contiguous()


@pytest.mark.parametrize("wkw", [{"backend": "pallas_wagg:f32"},
                                 {"backend": "einsum:int8",
                                  "policy": "ema(0.9)"},
                                 {"backend": "hierarchical:f32", "n_pods": 2,
                                  "strategy": "inverse"}])
def test_communicate_matches_jax(wkw):
    params, axes = _tree(seed=8)
    h = _energies(np.random.default_rng(9), 4)
    ours = twasgd.communicate(_tmap(_t, params), axes, _t(h),
                              tcfg.WASGDConfig(**wkw))
    ref = jwasgd.communicate(_tmap(jnp.asarray, params), axes,
                             jnp.asarray(h), jcfg.WASGDConfig(**wkw))
    for o, r in zip(_leaves(ours.params), _leaves(ref.params)):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0, atol=ATOL)
    for a, b in ((ours.theta, ref.theta), (ours.scores, ref.scores)):
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=ATOL)
    for k in ("theta_entropy", "omega", "h_mean", "h_min"):
        np.testing.assert_allclose(_np(ours.metrics[k]), ref.metrics[k],
                                   rtol=0, atol=ATOL)
