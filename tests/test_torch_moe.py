"""The port's MoE layer, the MoE and hybrid configs (olmoe-1b-7b,
arctic-480b, jamba-v0.1-52b) and their training and serving against the
JAX package, at the smoke sizes.

Inputs come from numpy seeds; JAX runs on the CPU; both packages hold the
same weights (JAX's, carried across by ``params_from_numpy``). Router
inputs are continuous random draws, so no two router probabilities of a
token tie (``torch.topk`` does not promise JAX's lower-index-first order
between equal values).

Tolerances, float32 compute:
  * ``moe_ffn``: outputs 1e-5 relative to the largest output (measured
    1.5e-6 absolute on outputs of order ten), the aux losses 1e-5
    relative, gradients 1e-5 relative to each leaf's largest entry, but
    the router's under top-1 routing (``TOP1_ROUTER_RTOL``).
  * Model logits 1e-5 relative to the largest logit (measured 1.1e-5
    absolute on jamba's logits of order ten: float32 sums in another
    order through 4 layers), the loss and ``moe_loss`` 1e-5 relative,
    gradients 1e-5 relative to each leaf's largest entry (measured
    5.7e-6).
  * Trainer rounds: h and losses rtol 1e-5, theta atol 1e-6, params atol
    1e-5 every round, as ``tests/test_torch_lm.py``.
  * Serving: greedy tokens equal to JAX's.
"""
import dataclasses
import functools
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.serve import ContinuousEngine as JEngine  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.lm import make_lm_loss as j_make_lm_loss  # noqa: E402
from repro_torch.configs import (MoEConfig, ModelConfig,  # noqa: E402
                                 TrainConfig, WASGDConfig, get_config,
                                 get_smoke_config)
from repro_torch.core import (is_worker_leaf, replicate_workers,  # noqa: E402
                              worker_in_axes)
from repro_torch.data import OrderedDataset, make_tokens  # noqa: E402
from repro_torch.models import (cast_params, forward,  # noqa: E402
                                init_params, loss_fn, param_axes,
                                params_from_numpy)
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import ContinuousEngine, ServeEngine  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.train.step import _round_parts  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

MOE_ARCHS = ["olmoe-1b-7b", "arctic-480b", "jamba-v0.1-52b"]
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def _cfgs(arch, compute_dtype="float32"):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    return j_init_params(jax_smoke(arch), jax.random.key(seed))


def _params(arch, seed=0):
    jp, axes = _jax_params(arch, seed)
    return jp, axes, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy().copy()}
    return {prefix: np.array(tree, copy=True)}


def _batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _close_rel(got, ref, rtol, what=""):
    """max|got - ref| <= rtol * max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), what


# -- configs ---------------------------------------------------------------------

def test_moe_config_matches_jax_field_for_field():
    ours = [(f.name, f.default) for f in dataclasses.fields(MoEConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JMoEConfig)]
    assert ours == ref


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_configs_match_jax_field_for_field(arch, which):
    ours = (get_config if which == "full" else get_smoke_config)(arch)
    ref = (jax_get_config if which == "full" else jax_smoke)(arch)
    for f in PORT_FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        if f in ("moe", "ssm") and b is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f
        else:
            assert a == b, f
    assert isinstance(ours.moe, MoEConfig)
    assert ours.expert_sharding == ref.expert_sharding == "ep_data"


@pytest.mark.parametrize("moe", [(64, 8, 1.25), (16, 2, 1.25), (4, 2, 0.1),
                                 (128, 2, 1.0)])
def test_capacity_matches_jax_over_a_grid_of_token_counts(moe):
    E, K, cf = moe
    m = MoEConfig(E, K, 8, capacity_factor=cf)
    jm = JMoEConfig(E, K, 8, capacity_factor=cf)
    for T in list(range(1, 70)) + [127, 128, 640, 1920, 2560, 16384]:
        assert TM._capacity(T, m) == JM._capacity(T, jm), T


# -- the MoE FFN ------------------------------------------------------------------

# (n_experts, top_k, capacity_factor, b, s): no drops; the default factor;
# the drop case of tests/test_moe.py:54 (top-1, factor 0.1) and its top-2
# form; olmoe's routing shape
FFN_CASES = {"no_drop": (4, 2, 8.0, 2, 16), "default": (8, 2, 1.25, 2, 24),
             "drops": (4, 1, 0.1, 2, 64), "drops_top2": (4, 2, 0.1, 2, 64),
             "olmoe_shape": (64, 8, 1.25, 2, 20)}
# With top-1 routing the renormalized gate is g / g = 1: its gradient to
# the router is zero, computed in both packages as the difference of two
# equal float32 terms, so the router's gradient there (the aux losses'
# terms, some 1e-3) carries rounding noise of some 1e-7 in either package
TOP1_ROUTER_RTOL = 1e-3


def _ffn_inputs(E, K, cf, b, s, seed, d=16, f=24):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, E)).astype(np.float32),
         "experts": {
             "w_gate": (0.3 * rng.normal(size=(E, d, f))).astype(np.float32),
             "w_up": (0.3 * rng.normal(size=(E, d, f))).astype(np.float32),
             "w_down": (0.3 * rng.normal(size=(E, f, d))).astype(np.float32)}}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(b, s, d)).astype(np.float32)   # output cotangent
    return (MoEConfig(E, K, f, capacity_factor=cf),
            JMoEConfig(E, K, f, capacity_factor=cf), p, x, w)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax_outputs_aux_and_gradients(case):
    m, jm, p, x, w = _ffn_inputs(*FFN_CASES[case], seed=len(case))

    def j_obj(params, x):
        y, aux = JM.moe_ffn(params, x, jm, jnp.float32)
        return (jnp.sum(y * w) + aux.load_balance_loss
                + aux.router_z_loss), (y, aux)

    (jv, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = TM.moe_ffn(tp, tx, m, torch.float32)
    tv = (ty * torch.from_numpy(w)).sum() + taux.load_balance_loss \
        + taux.router_z_loss
    tv.backward()
    _close_rel(ty.detach().numpy(), jy, 1e-5, "y")
    for name in ("load_balance_loss", "router_z_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(getattr(taux, name).detach()),
                                   float(getattr(jaux, name)), rtol=1e-5,
                                   atol=1e-12, err_msg=name)
    if case.startswith("drops"):
        assert float(taux.dropped_fraction) > 0.5
    elif case == "no_drop":
        assert float(taux.dropped_fraction) == 0.0
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    _close_rel(tx.grad.numpy(), jg[1], 1e-5, "dx")
    flat_t = _flat({"router": tp["router"].grad,
                    "experts": {k: v.grad for k, v in
                                tp["experts"].items()}})
    for k, ref in _flat(jg[0]).items():
        rtol = TOP1_ROUTER_RTOL if (m.top_k == 1 and k == "/router") \
            else 1e-5
        _close_rel(flat_t[k], ref, rtol, k)


def test_moe_ffn_under_vmap_over_workers_matches_a_loop():
    """The round's form: the router mapped over 3 workers, the experts
    one unmapped copy. Outputs equal a loop over workers, the experts'
    gradient is the sum of the workers' gradients, and no op falls back
    to vmap's per-example loop."""
    m, _, p, x, w = _ffn_inputs(8, 2, 0.5, 2, 24, seed=5)
    rng = np.random.default_rng(6)
    router = torch.from_numpy(rng.normal(size=(3,) + p["router"].shape)
                              .astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(3,) + x.shape).astype(np.float32))
    experts = {k: torch.from_numpy(v) for k, v in p["experts"].items()}

    def loss(r, ex, x):
        y, aux = TM.moe_ffn({"router": r, "experts": ex}, x, m, torch.float32)
        return (y * torch.from_numpy(w)).sum() + aux.load_balance_loss, y

    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            (gr, gex), (vals, ys) = torch.func.grad_and_value(
                lambda r, ex: tuple(t.sum() if i == 0 else t for i, t in
                                    enumerate(torch.func.vmap(
                                        loss, in_dims=(0, None, 0))(
                                        r, ex, xs))),
                argnums=(0, 1), has_aux=True)(router, experts)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    loop_g = [torch.func.grad(lambda r, ex: loss(r, ex, xs[i])[0],
                              argnums=(0, 1))(router[i], experts)
              for i in range(3)]
    for i in range(3):
        np.testing.assert_allclose(ys[i].numpy(),
                                   loss(router[i], experts, xs[i])[1].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(gr[i].numpy(), loop_g[i][0].numpy(),
                                   rtol=0, atol=1e-5)
    for k in experts:
        want = sum(g[1][k] for g in loop_g)
        np.testing.assert_allclose(gex[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# -- the models ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_tree_matches_jax_and_carries_across(arch):
    """The port's init builds JAX's tree (names, shapes: ``moe/router``,
    ``moe/experts/w_*``, arctic's ``dense_mlp``, jamba's MLPs after its
    even SSM layers), and JAX's params carry across exactly."""
    _, cfg = _cfgs(arch)
    jp, _, tp = _params(arch)
    ours = _flat(init_params(cfg, 0, device="cpu"))
    ref = _flat(jp)
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    came = _flat(tp)
    for k in ref:
        np.testing.assert_array_equal(came[k], ref[k])
    if arch == "arctic-480b":
        assert "/layers/L0/dense_mlp/w_gate" in ours
    if arch == "jamba-v0.1-52b":
        assert "/layers/L0/mlp/w_gate" in ours and "/layers/L0/ssm/A_log" \
            in ours and "/layers/L1/moe/router" in ours


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_logits_and_moe_loss_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=1)
    toks = _batch(cfg, 1)["tokens"]
    jl, jm = jax.jit(functools.partial(j_forward, jcfg))(jp,
                                                          jnp.asarray(toks))
    tl, tm = forward(cfg, tp, torch.from_numpy(toks))
    _close_rel(tl.numpy(), jl, 1e-5, "logits")
    assert float(jm) > 0
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=2)
    batch = _batch(cfg, 2)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    (tg, (tl, taux)) = torch.func.grad_and_value(
        lambda p: loss_fn(cfg, p, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}),
        has_aux=True)(tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("ce", "moe_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)
    ft, fj = _flat(tg), _flat(jg)
    assert sorted(ft) == sorted(fj)
    for k in fj:
        _close_rel(ft[k], fj[k], 1e-5, k)


# -- expert leaves in the round ----------------------------------------------------

def test_param_axes_keep_expert_leaves_single_copy():
    _, cfg = _cfgs("olmoe-1b-7b")
    params = init_params(cfg, 0, device="cpu")
    axes = param_axes(params)
    assert axes["layers"]["L0"]["moe"]["experts"]["w_up"] == \
        ("experts", None, None)
    assert axes["layers"]["L0"]["moe"]["router"] == (None, None)
    stacked, saxes = replicate_workers(params, axes, 3)
    for path, x in _flat(stacked).items():
        ax = _flat_axes(saxes)[path]
        if "/experts/" in path:
            assert not is_worker_leaf(ax)
            assert x.shape == _flat(params)[path].shape
        else:
            assert is_worker_leaf(ax) and x.shape[0] == 3
    copies, caxes = replicate_workers(params, axes, 3, expert_copies=True)
    assert all(is_worker_leaf(ax) for ax in tree_leaves(caxes))


def _flat_axes(axes, prefix=""):
    out = {}
    for k, v in axes.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def test_trainer_reads_expert_copies_from_the_train_config():
    """As JAX's Trainer: ``getattr(tcfg, "expert_copies", False)``."""
    _, cfg = _cfgs("olmoe-1b-7b")
    params = init_params(cfg, 0, device="cpu")
    tcfg = TrainConfig(learning_rate=0.01, wasgd=WASGDConfig(tau=1))
    tr = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg, 2,
                 device="cpu")
    assert not is_worker_leaf(tr.axes["layers"]["L1"]["moe"]["experts"]
                              ["w_down"])

    @dataclasses.dataclass(frozen=True)
    class WithCopies(TrainConfig):
        expert_copies: bool = True

    tr = Trainer(make_lm_loss(cfg), params, param_axes(params),
                 WithCopies(learning_rate=0.01, wasgd=WASGDConfig(tau=1)), 2,
                 device="cpu")
    assert is_worker_leaf(tr.axes["layers"]["L1"]["moe"]["experts"]
                          ["w_down"])


def test_round_gives_expert_leaves_the_workers_mean_gradient():
    """One local step of the round (``worker_grads``) on 3 workers with
    their own routers and batches: a worker leaf's gradient is that
    worker's own, the single expert copy's is the mean of the workers'
    gradients, each from ``loss_fn`` of that worker's params alone."""
    _, cfg = _cfgs("olmoe-1b-7b")
    base = init_params(cfg, 3, device="cpu")
    params, axes = replicate_workers(base, param_axes(base), 3)
    gen = torch.Generator().manual_seed(0)
    for lp in params["layers"].values():
        r = lp["moe"]["router"]
        lp["moe"]["router"] = r + 0.05 * torch.randn(r.shape, generator=gen)
    toks = make_tokens(1, 6, 16, cfg.vocab_size)
    mb = {"tokens": torch.from_numpy(toks[:, :-1]).reshape(3, 2, 16),
          "labels": torch.from_numpy(toks[:, 1:]).reshape(3, 2, 16)}
    parts = _round_parts(make_lm_loss(cfg), make_optimizer("sgd", 0.1), axes,
                         WASGDConfig(tau=1), 3)
    grads, losses = parts.worker_grads(params, mb)
    in_dims = worker_in_axes(axes)
    per_worker = []
    for w in range(3):
        pw = tree_map(lambda x, d: x[w] if d == 0 else x, params, in_dims)
        g, (lw, _) = torch.func.grad_and_value(
            lambda p: loss_fn(cfg, p, {k: v[w] for k, v in mb.items()}),
            has_aux=True)(pw)
        np.testing.assert_allclose(float(losses[w]), float(lw), rtol=1e-6)
        per_worker.append(_flat(g))
    fg, fd = _flat(grads), _flat_axes(in_dims)
    for k, g in fg.items():
        if fd[k] is None:
            want = sum(pw[k] for pw in per_worker) / 3
            assert "/experts/" in k
        else:
            want = np.stack([pw[k] for pw in per_worker])
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-12,
                                   err_msg=k)


def test_aggregation_leaves_expert_leaves_alone():
    """A ``pallas_wagg`` round: the aggregate runs once per worker leaf (the
    kernel's plain version here) and never on an expert leaf, which keeps
    its one copy and takes only the SGD update of its mean gradient."""
    _, cfg = _cfgs("olmoe-1b-7b")
    params = init_params(cfg, 4, device="cpu")
    tcfg = TrainConfig(learning_rate=0.05, optimizer="sgd",
                       wasgd=WASGDConfig(tau=2, backend="pallas_wagg:f32"))
    tr = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg, 2,
                 device="cpu")
    mod = importlib.import_module("repro_torch.kernels.wagg.wagg")
    shapes = []
    orig = mod.wagg_fused_ref

    def counting(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return orig(x, *a, **kw)

    mod.wagg_fused_ref = counting
    try:
        toks = make_tokens(2, 8, 16, cfg.vocab_size)
        tr.run(iter([{"tokens": toks[:, :-1], "labels": toks[:, 1:]}]), 1)
    finally:
        mod.wagg_fused_ref = orig
    worker = [x for x, ax in zip(tree_leaves(tr.state.params),
                                 tree_leaves(tr.axes)) if is_worker_leaf(ax)]
    experts = [x for x, ax in zip(tree_leaves(tr.state.params),
                                  tree_leaves(tr.axes))
               if not is_worker_leaf(ax)]
    assert len(shapes) == len(worker) and len(experts) == 3 * cfg.n_layers
    assert all(s[0] == 2 for s in shapes)
    assert all(x.shape[0] == cfg.moe.n_experts for x in experts)


# -- Trainer rounds against JAX's --------------------------------------------------

P, TAU, B_LOCAL, SEQ, ROUNDS = 2, 2, 2, 32, 3


def trainer_run(framework, jcfg, cfg, jp, axes):
    """WASGD+ rounds of ``cfg`` through one package's Trainer from the
    numpy params ``jp``; returns the trainer and each round's params
    (numpy)."""
    toks = make_tokens(0, 256, SEQ, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    wkw = dict(tau=TAU, beta=0.9, a_tilde=1.0, strategy="boltzmann")
    if framework == "jax":
        # a fresh copy: the JAX Trainer donates the params it is given
        tr = JTrainer(j_make_lm_loss(jcfg), jax.tree.map(jnp.asarray, jp),
                      axes,
                      JTrainConfig(learning_rate=0.03, optimizer="sgd",
                                   wasgd=JWASGDConfig(**wkw)), P,
                      rule="wasgd+")
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2)
    else:
        params = params_from_numpy(jp, "cpu")
        tr = Trainer(make_lm_loss(cfg), params, param_axes(params),
                     TrainConfig(learning_rate=0.03, optimizer="sgd",
                                 wasgd=WASGDConfig(**wkw)), P, rule="wasgd+",
                     device="cpu")
        ds = OrderedDataset(data, P, TAU, B_LOCAL, n_segments=2)
    snaps = []
    step = tr._step

    def recording_step(state, batch):
        out = step(state, batch)
        snaps.append(_flat(out[0].params))
        return out

    tr._step = recording_step
    tr.run(ds.batches(), ROUNDS, order_state=ds.order,
           segment_fn=ds.segment_of_round)
    return tr, snaps


def assert_rounds_match(tr_j, snaps_j, tr_t, snaps_t):
    assert len(snaps_t) == len(snaps_j) == ROUNDS
    for r in range(ROUNDS):
        hj, ht = tr_j.history[r], tr_t.history[r]
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
        assert sorted(snaps_t[r]) == sorted(snaps_j[r])
        for k, ref in snaps_j[r].items():
            assert snaps_t[r][k].shape == ref.shape, k
            np.testing.assert_allclose(snaps_t[r][k], ref, rtol=0,
                                       atol=1e-5, err_msg=f"round {r} {k}")


def test_olmoe_trainer_matches_jax_round_by_round():
    """olmoe-smoke through both Trainers: the expert leaves stay one copy
    (shape without the worker axis) in both, every round."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    jp, axes, _ = _params("olmoe-1b-7b", seed=5)
    jp = jax.tree.map(np.asarray, jp)
    tr_j, snaps_j = trainer_run("jax", jcfg, cfg, jp, axes)
    tr_t, snaps_t = trainer_run("port", jcfg, cfg, jp, axes)
    assert_rounds_match(tr_j, snaps_j, tr_t, snaps_t)
    w_up = snaps_t[-1]["/layers/L0/moe/experts/w_up"]
    assert w_up.shape == (cfg.moe.n_experts, cfg.d_model,
                          cfg.moe.d_ff_expert)


# -- serving --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_continuous_engine_matches_jax_under_insert_evict(arch):
    """Five requests on two slots through both ``ContinuousEngine``s,
    float32 weights and cache: requests finish mid-flight, slots recycle
    and later requests join running ones. Each decode step routes all the
    batch's rows together (the finished rows too), as JAX's does, so the
    capacity and the tokens competing for it are the same."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=6)
    kw = dict(n_slots=2, max_len=48, block_size=8, chunk=8)
    jeng = JEngine(jcfg, jp, cache_dtype=jnp.float32, **kw)
    teng = ContinuousEngine(cfg, tp, cache_dtype=torch.float32,
                            device="cpu", **kw)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((8, 3), (20, 17), (8, 7), (12, 9), (3, 1))]
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, n, seed=i) for i, (p, n) in enumerate(reqs)]
        done = eng.run()
        outs.append([np.asarray(done[r]) for r in rids])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert teng.scheduler.idle and teng.n_running == 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_serve_engine_matches_jax_greedy(arch):
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=8)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(JServeEngine(jcfg, jp, max_len=40,
                                   cache_dtype=jnp.float32).generate(
        prompts, 10))
    got = ServeEngine(cfg, tp, max_len=40, cache_dtype=torch.float32,
                      device="cpu").generate(prompts, 10)
    np.testing.assert_array_equal(got, want)


def test_cast_params_keeps_the_router_in_float32():
    """The serving copy in bf16: every matrix but the router, whose logits
    are float32 in both packages."""
    _, cfg = _cfgs("olmoe-1b-7b")
    params = cast_params(init_params(cfg, 0, device="cpu"), torch.bfloat16)
    lp = params["layers"]["L0"]
    assert lp["moe"]["router"].dtype == torch.float32
    assert lp["moe"]["experts"]["w_gate"].dtype == torch.bfloat16
    assert lp["attn"]["wq"].dtype == torch.bfloat16
    assert lp["ffn_norm"]["scale"].dtype == torch.float32


def _olmoe_trainer(p=2):
    _, cfg = _cfgs("olmoe-1b-7b")
    params = init_params(cfg, 6, device="cpu")
    tr = Trainer(make_lm_loss(cfg), params, param_axes(params),
                 TrainConfig(learning_rate=0.03, optimizer="sgd",
                             wasgd=WASGDConfig(tau=2)), p, rule="wasgd+",
                 device="cpu")
    toks = make_tokens(3, 64, 16, cfg.vocab_size)
    ds = OrderedDataset({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                        p, 2, 2, n_segments=2)
    return cfg, tr, ds


def test_sharded_checkpoint_keeps_the_single_expert_copy(tmp_path):
    """A sharded checkpoint of an olmoe trainer (the experts one copy, the
    rest per worker) resumes into a fresh trainer bit for bit, and the
    resumed run goes on as the saved one does."""
    _, tr, ds = _olmoe_trainer()
    tr.run(ds, 1)
    tr.save_checkpoint(str(tmp_path / "ck"), 1)
    tr._ckpt.wait()
    _, other, _ = _olmoe_trainer()
    assert other.resume(str(tmp_path / "ck")) == 1
    a, b = _flat(other.state.params), _flat(tr.state.params)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["/layers/L0/moe/experts/w_up"].shape == (4, 128, 64)


def test_consensus_of_an_moe_trainer_serves():
    """``consensus_params`` of an olmoe trainer keeps the expert copy as it
    is and averages the worker leaves; ``HotSwapBridge`` swaps it into a
    running engine, which decodes with it."""
    from repro_torch.serve import HotSwapBridge
    from repro_torch.train.evaluate import consensus_params
    cfg, tr, ds = _olmoe_trainer()
    tr.run(ds, 1)
    cons = consensus_params(tr.state.params, tr.axes)
    lp, tlp = cons["layers"]["L0"], tr.state.params["layers"]["L0"]
    assert lp["moe"]["experts"]["w_gate"] is tlp["moe"]["experts"]["w_gate"]
    np.testing.assert_allclose(lp["moe"]["router"].numpy(),
                               tlp["moe"]["router"].mean(0).numpy(),
                               rtol=0, atol=1e-7)
    eng = ContinuousEngine(cfg, cons, n_slots=2, max_len=32, block_size=8,
                           device="cpu")
    bridge = HotSwapBridge(eng)
    rid = eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.step()
    rec = bridge(1, tr.state.params, tr.axes)
    assert rec["param_drift_l2"] == 0.0 and eng.n_swaps == 1
    out = eng.run()[rid]
    assert out.shape == (4,) and (out >= 0).all()
