"""The port's dense LM training slice against the JAX package.

The smoke configs of gemma3, stablelm-1.6b, stablelm-3b and yi-6b (GQA
group 4, rope_theta 5e6) run through both packages from JAX's parameters
carried across (``params_from_numpy``); token batches
come from numpy. On the CPU the port's norms and CE take the kernels'
plain versions through their ``autograd.Function``s (``setup_context``,
the ``vmap`` rule and the backward run as on the card).

Tolerances:
  * float32 compute: logits 1e-5 absolute (values below 5; the two
    packages differ in the order of their sums: measured 3.3e-6), loss
    1e-5 relative (measured 7e-8), gradients 1e-5 relative to each leaf's
    largest entry (measured 1.3e-6).
  * bfloat16 compute: 2e-2 relative to the largest logit (one bf16 ulp
    of a value in [2, 4) is 2^-5, 0.8% of 4; measured 7.8e-3), loss 2e-2
    relative (measured 2.2e-4).
  * The quickstart-shaped run (p 4, tau 4, b_local 2, seq 64, stablelm
    smoke, float32 compute, 3 rounds) through both ``Trainer``s: loss and
    h rtol 1e-5, theta atol 1e-6, params atol 1e-5 every round (the port
    takes each worker's gradient of its own loss, JAX the gradient of the
    mean scaled by p: they agree up to rounding).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.data import make_tokens as j_make_tokens  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.lm import make_lm_loss as j_make_lm_loss  # noqa: E402
from repro_torch.configs import (ARCH_IDS, TrainConfig,  # noqa: E402
                                 WASGDConfig, get_config, get_smoke_config)
from repro_torch.core import is_worker_leaf, replicate_workers  # noqa: E402
from repro_torch.data import (OrderedDataset, lm_batch,  # noqa: E402
                              make_tokens)
from repro_torch.kernels.fused_ce import fused_ce_fwd, fused_ce_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_fwd, rmsnorm_ref  # noqa: E402
from repro_torch.models import (decode_step_paged, forward,  # noqa: E402
                                init_params, loss_fn, param_axes,
                                params_from_numpy)
from repro_torch.serve import PagedCache  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["gemma3-1b", "stablelm-1.6b", "stablelm-3b", "yi-6b"]
NEW_FIELDS = ("remat", "sharded_ce", "unroll_attn_scan", "windowed_qblock")


def _cfgs(arch, compute_dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype,
                               **kw)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype=compute_dtype, **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    """JAX's smoke params (float32 whatever the compute dtype), made once
    per (arch, seed): JAX's eager init takes seconds."""
    return j_init_params(jax_smoke(arch), jax.random.key(seed))


def _params(arch, seed=0):
    jp, axes = _jax_params(arch, seed)
    return jp, axes, params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _batch(cfg, seed=0, b=2, s=40):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy().copy()}
    return {prefix: np.array(tree, copy=True)}


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_stablelm_config_matches_jax_field_for_field(which):
    ours = (get_config if which == "full" else get_smoke_config)(
        "stablelm-1.6b")
    ref = (jax_get_config if which == "full" else jax_smoke)("stablelm-1.6b")
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
def test_dense_configs_match_jax_field_for_field(arch, which):
    ours = (get_config if which == "full" else get_smoke_config)(arch)
    ref = (jax_get_config if which == "full" else jax_smoke)(arch)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_training_fields_carry_jax_defaults(arch):
    """The fields the training forward reads have JAX's values in the full
    and smoke configs (remat: True in the full configs, False in the
    smoke ones)."""
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        for f in NEW_FIELDS:
            assert getattr(ours, f) == getattr(ref, f), f
    assert get_config(arch).remat is True
    assert set(ARCH_IDS) >= set(ARCHS)


# -- params ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_jax_lm_params_carry_across_with_names_and_layouts(arch):
    """The smoke trees (gemma3: tied embed; stablelm: untied ``head/w``)
    land under the port's own names with the port's shapes, exactly."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch)
    ours = _flat(init_params(cfg, 0, device="cpu"))
    came = _flat(tp)
    assert sorted(came) == sorted(ours)
    assert ("/head/w" in ours) == (not cfg.tie_embeddings)
    ref = _flat(jp)
    for k in ours:
        assert came[k].shape == ours[k].shape, k
        np.testing.assert_array_equal(came[k], ref[k])


def test_param_axes_put_every_leaf_on_the_worker_axis():
    _, cfg = _cfgs("stablelm-1.6b")
    params = init_params(cfg, 0, device="cpu")
    stacked, axes = replicate_workers(params, param_axes(params), 4)
    for x, ax in zip(tree_leaves(stacked), tree_leaves(axes)):
        assert is_worker_leaf(ax) and x.shape[0] == 4


# -- forward and loss --------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, compute_dtype):
    jcfg, cfg = _cfgs(arch, compute_dtype)
    jp, _, tp = _params(arch)
    toks = _batch(cfg)["tokens"]
    ref = np.asarray(jax.jit(functools.partial(j_forward, jcfg))(
        jp, jnp.asarray(toks))[0], np.float32)
    logits, moe = forward(cfg, tp, torch.from_numpy(toks))
    assert logits.dtype == getattr(torch, compute_dtype)
    assert float(moe) == 0.0
    err = np.abs(logits.float().numpy() - ref).max()
    if compute_dtype == "float32":
        assert err <= 1e-5
    else:
        assert err <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("sharded_ce", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax_in_both_ce_forms(arch, compute_dtype,
                                              sharded_ce):
    jcfg, cfg = _cfgs(arch, compute_dtype, sharded_ce=sharded_ce)
    jp, _, tp = _params(arch)
    batch = _batch(cfg, seed=1)
    jl, jaux = jax.jit(functools.partial(j_loss_fn, jcfg))(
        jp, jax.tree.map(jnp.asarray, batch))
    tl, taux = loss_fn(cfg, tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    rtol = 1e-5 if compute_dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=rtol)
    assert float(taux["moe_loss"]) == float(jaux["moe_loss"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    """The custom backwards of the norm and CE Functions, end to end: the
    gradient of the float32 loss equals ``jax.grad`` of JAX's loss."""
    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=2)
    batch = _batch(cfg, seed=2)
    jg = _flat(jax.jit(jax.grad(lambda p: j_loss_fn(
        jcfg, p, jax.tree.map(jnp.asarray, batch))[0]))(jp))
    tg = _flat(torch.func.grad(lambda p: loss_fn(
        cfg, p, {k: torch.from_numpy(v) for k, v in batch.items()})[0])(tp))
    assert sorted(tg) == sorted(jg)
    for k in jg:
        scale = np.abs(jg[k]).max()
        assert np.abs(tg[k] - jg[k]).max() <= 1e-5 * scale, k


@pytest.mark.parametrize("arch", ARCHS)
def test_kernels_and_plain_versions_give_the_same_loss(arch):
    """``norm=``/``ce=`` take the plain versions (what ``chip_smoke.py``
    compares the kernels with); on the CPU the kernels' Functions run the
    same plain math, so loss and gradients agree to rounding."""
    _, cfg = _cfgs(arch)
    params = init_params(cfg, 3, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}

    def grads(**kw):
        return torch.func.grad_and_value(
            lambda p: loss_fn(cfg, p, batch, **kw)[0])(params)

    gk, lk = grads()
    gp, lp = grads(norm=rmsnorm_ref, ce=fused_ce_ref)
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-6)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()) + 1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step_call_the_norm_2L_plus_1_times(arch):
    """53 norms per forward and per decode step at gemma3-1b's 26 layers;
    the CPU launches nothing."""
    _, cfg = _cfgs(arch)
    params = init_params(cfg, 0, device="cpu")
    calls = []

    def counting(x, scale, eps):
        calls.append(x.shape)
        return rmsnorm_ref(x, scale, eps)

    before = (rmsnorm_fwd.launches, fused_ce_fwd.launches)
    forward(cfg, params, torch.zeros((1, 8), dtype=torch.int32),
            norm=counting)
    assert len(calls) == 2 * cfg.n_layers + 1
    cache = PagedCache(cfg, 2, 32, 8, dtype=torch.float32, device="cpu")
    cache.reserve(0, 8)
    calls.clear()
    decode_step_paged(cfg, params, torch.zeros((2, 1), dtype=torch.int32),
                      cache.pools, cache.tables,
                      torch.zeros(2, dtype=torch.int32), max_len=32,
                      block_size=8, norm=counting)
    assert len(calls) == 2 * cfg.n_layers + 1
    loss_fn(cfg, params, {k: torch.from_numpy(v)
                          for k, v in _batch(cfg).items()})
    assert (rmsnorm_fwd.launches, fused_ce_fwd.launches) == before


# -- data ------------------------------------------------------------------------

def test_token_data_is_the_jax_packages():
    for ours, ref in ((make_tokens(3, 17, 33, 500),
                       j_make_tokens(3, 17, 33, 500)),
                      (make_tokens(0, 4, 8, 262144, p_follow=0.5),
                       j_make_tokens(0, 4, 8, 262144, p_follow=0.5))):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    for kw in ({}, {"n_codebooks": 3}, {"media_tokens": 4, "d_model": 6}):
        ours, ref = lm_batch(5, 3, 12, 300, **kw), j_lm_batch(5, 3, 12, 300,
                                                              **kw)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


# -- the quickstart-shaped round -------------------------------------------------

P, TAU, B_LOCAL, SEQ, ROUNDS = 4, 4, 2, 64, 3


def _quickstart_run(framework, jcfg, cfg, jp, axes):
    toks = make_tokens(0, 2048, SEQ, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    wkw = dict(tau=TAU, beta=0.9, a_tilde=1.0, strategy="boltzmann")
    if framework == "jax":
        tr = JTrainer(j_make_lm_loss(jcfg), jp, axes,
                      JTrainConfig(learning_rate=0.03, optimizer="sgd",
                                   wasgd=JWASGDConfig(**wkw)), P,
                      rule="wasgd")
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2)
    else:
        params = params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
        tr = Trainer(make_lm_loss(cfg), params, param_axes(params),
                     TrainConfig(learning_rate=0.03, optimizer="sgd",
                                 wasgd=WASGDConfig(**wkw)), P, rule="wasgd",
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


def test_quickstart_shaped_trainer_matches_jax_round_by_round():
    jcfg, cfg = _cfgs("stablelm-1.6b")
    jp, axes, _ = _params("stablelm-1.6b")
    tr_j, snaps_j = _quickstart_run("jax", jcfg, cfg, jp, axes)
    tr_t, snaps_t = _quickstart_run("port", jcfg, cfg, jp, axes)
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
            assert snaps_t[r][k].shape == ref.shape == (P,) + ref.shape[1:]
            np.testing.assert_allclose(snaps_t[r][k], ref, rtol=0,
                                       atol=1e-5,
                                       err_msg=f"round {r} {k}")


def test_round_frees_round_start_params_after_the_first_step():
    """The round consumes its state, as the JAX Trainer donates it: from
    the second local step on no reference to the round-start parameter
    tensors is left (each step's new tensors replace the dicts' leaves),
    and no tensor the caller holds is written."""
    import weakref

    from repro_torch.optim import make_optimizer
    from repro_torch.train import build_train_step, init_state

    _, cfg = _cfgs("stablelm-1.6b")
    base = init_params(cfg, 0, device="cpu")
    params, axes = replicate_workers(base, param_axes(base), 2)
    held = _flat(base)
    refs = [weakref.ref(x) for x in tree_leaves(params)]
    alive = []

    def loss(p, b):
        alive.append(sum(r() is not None for r in refs))
        return make_lm_loss(cfg)(p, b)

    opt = make_optimizer("sgd", 0.03)
    step = build_train_step(loss, opt, axes, WASGDConfig(tau=3), 2)
    toks = make_tokens(0, 12, 16, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    state = init_state(params, opt.init(params), 2)
    del params
    step(state, batch)
    assert alive == [len(refs), 0, 0]
    for k, v in _flat(base).items():
        np.testing.assert_array_equal(v, held[k], err_msg=k)


# -- serving the new dense configs ------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-6b"])
def test_greedy_serve_matches_jax_engine(arch):
    """Four requests on two slots through both ``ContinuousEngine``s, float32
    weights and cache: the port's greedy tokens are JAX's."""
    from repro.serve import ContinuousEngine as JEngine
    from repro_torch.serve import ContinuousEngine

    jcfg, cfg = _cfgs(arch)
    jp, _, tp = _params(arch, seed=4)
    kw = dict(n_slots=2, max_len=48, block_size=8, chunk=4)
    jeng = JEngine(jcfg, jp, cache_dtype=jnp.float32, **kw)
    teng = ContinuousEngine(cfg, tp, cache_dtype=torch.float32,
                            device="cpu", **kw)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((7, 9), (19, 4), (3, 12), (11, 6))]
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, n) for p, n in reqs]
        done = eng.run()
        outs.append([np.asarray(done[r]) for r in rids])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert [len(g) for g in outs[1]] == [n for _, n in reqs]
