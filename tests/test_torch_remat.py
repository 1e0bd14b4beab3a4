"""``remat`` under the vmapped round and the leaf-wise optimizer update,
against the port itself and the JAX package.

The round takes the LM loss's worker-stacked form
(``models.transformer.worker_losses``): each layer ``vmap``ped, and
checkpointed outside its ``vmap`` when ``cfg.remat`` is set. On the CPU
the recompute is bitwise the first forward, so per-worker losses and
gradients with ``remat`` on equal those with it off and those of a
``vmap`` of the whole loss, bit for bit. Against JAX (``jax.grad`` of its
loss with ``remat=True``, one worker at a time, float32 compute) the
gradients agree within 1e-5 of each leaf's largest entry, the LM
tolerance of ``tests/test_torch_lm.py``. The leaf-wise ``apply`` of each
optimizer is bitwise its tree-wise ``update`` over 3 local steps.
"""
import dataclasses
import functools
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.lm import make_lm_loss as j_make_lm_loss  # noqa: E402
from repro_torch.configs import (TrainConfig, WASGDConfig,  # noqa: E402
                                 get_smoke_config)
from repro_torch.core import replicate_workers, worker_in_axes  # noqa: E402
from repro_torch.data import OrderedDataset, lm_batch, make_tokens  # noqa: E402
from repro_torch.kernels.fused_ce import fused_ce_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_ref  # noqa: E402
from repro_torch.models import (init_params, loss_fn, param_axes,  # noqa: E402
                                params_from_numpy, worker_losses)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.train.step import StackedLoss, _round_parts  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ["gemma3-1b", "stablelm-3b", "yi-6b"]
P = 2


def _cfgs(arch, remat=True):
    kw = dict(compute_dtype="float32", remat=remat)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return j_init_params(jax_smoke(arch), jax.random.key(5))


def _batch(seed, p=P, b=2, s=24, vocab=512):
    raw = lm_batch(seed, p * b, s, vocab)
    return raw, {k: torch.as_tensor(v).reshape(p, b, -1)
                 for k, v in raw.items()}


def _worker_grads(cfg, params, axes, mb, stacked=True):
    lf = make_lm_loss(cfg) if stacked else functools.partial(loss_fn, cfg)
    parts = _round_parts(lf, make_optimizer("sgd", 0.1), axes,
                         WASGDConfig(tau=1), P)
    grads, losses = parts.worker_grads(params, mb)
    return losses, tree_leaves(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise_the_ones_without_it(arch):
    _, cfg = _cfgs(arch)
    base = init_params(cfg, 0, device="cpu")
    params, axes = replicate_workers(base, param_axes(base), P)
    _, mb = _batch(0, vocab=cfg.vocab_size)
    ref_l, ref_g = _worker_grads(dataclasses.replace(cfg, remat=False),
                                 params, axes, mb, stacked=False)
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        losses, grads = _worker_grads(c, params, axes, mb)
        assert torch.equal(losses, ref_l), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_g)), remat


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_jax_grad_with_remat(arch):
    jcfg, cfg = _cfgs(arch)
    jp, _ = _jax_params(arch)
    base = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    params, axes = replicate_workers(base, param_axes(base), P)
    raw, mb = _batch(1, vocab=cfg.vocab_size)
    losses, grads = _worker_grads(cfg, params, axes, mb)
    jgrad = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss_fn(jcfg, q, b)[0]))
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    assert [g.shape[1:] for g in grads] == [x.shape for x in jleaves]
    for w in range(P):
        wb = {k: jnp.asarray(v.reshape(P, 2, -1)[w]) for k, v in raw.items()}
        jl, jg = jgrad(jp, wb)
        np.testing.assert_allclose(float(losses[w]), float(jl), rtol=1e-5)
        for g, ref in zip(grads, jax.tree.leaves(jg)):
            ref = np.asarray(ref)
            assert np.abs(g[w].numpy() - ref).max() <= 1e-5 * np.abs(
                ref).max() + 1e-12


@pytest.mark.parametrize("remat", [False, True])
def test_remat_runs_each_layers_norms_again_in_the_backward(remat):
    """2 * n_layers + 1 norms in the forward; with remat the backward
    recomputes each layer's two: 4 * n_layers + 1 a step."""
    _, cfg = _cfgs("gemma3-1b", remat)
    base = init_params(cfg, 0, device="cpu")
    params, axes = replicate_workers(base, param_axes(base), P)
    params = tree_map(lambda x: x.requires_grad_(), params)
    _, mb = _batch(2, vocab=cfg.vocab_size)
    calls = []

    def norm(x, scale, eps):
        calls.append(x.shape)
        return rmsnorm_ref(x, scale, eps)

    losses, _ = worker_losses(cfg, params, worker_in_axes(axes), mb,
                              norm=norm)
    assert len(calls) == 2 * cfg.n_layers + 1
    torch.autograd.grad(losses.sum(), tree_leaves(params))
    assert len(calls) == (4 if remat else 2) * cfg.n_layers + 1


def test_make_lm_loss_is_a_stacked_loss_through_its_norm_and_ce():
    """The round takes the LM loss's worker-stacked form (a ``StackedLoss``)
    and vmaps any other loss; both forms of ``make_lm_loss(cfg, norm=,
    ce=)`` run the norm and CE they are given."""
    _, cfg = _cfgs("gemma3-1b", True)
    assert isinstance(make_lm_loss(cfg), StackedLoss)
    assert not isinstance(functools.partial(loss_fn, cfg), StackedLoss)
    base = init_params(cfg, 0, device="cpu")
    params, axes = replicate_workers(base, param_axes(base), P)
    _, mb = _batch(3, vocab=cfg.vocab_size)
    calls = {"norm": 0, "ce": 0}

    def norm(x, scale, eps):
        calls["norm"] += 1
        return rmsnorm_ref(x, scale, eps)

    def ce(logits, labels):
        calls["ce"] += 1
        return fused_ce_ref(logits, labels)

    lf = make_lm_loss(cfg, norm=norm, ce=ce)
    losses, _ = lf.stacked(params, worker_in_axes(axes), mb)
    assert calls == {"norm": 2 * cfg.n_layers + 1, "ce": 1}
    one = {k: v[0] for k, v in mb.items()}
    loss, _ = lf(tree_map(lambda x: x[0], params), one)
    assert calls == {"norm": 4 * cfg.n_layers + 2, "ce": 2}
    torch.testing.assert_close(loss, losses[0], rtol=1e-5, atol=0)


# -- the leaf-wise update ---------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_leafwise_update_is_bitwise_the_treewise_one(name):
    """3 local steps of the same gradients through ``update`` (new trees,
    the inputs kept) and ``apply`` (leaf by leaf into the dicts): the same
    bits."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5), "blk": {"w": (3, 4, 2), "v": (3,)}}

    def draw():
        return tree_map(lambda s: torch.from_numpy(
            rng.normal(size=s).astype(np.float32)), shapes)

    opt = make_optimizer(name, 0.05, weight_decay=0.01)
    p_tree = draw()
    p_leaf = tree_map(torch.clone, p_tree)
    s_tree, s_leaf = opt.init(p_tree), opt.init(p_leaf)
    for _ in range(3):
        g = draw()
        p_old = p_tree
        p_tree, s_tree = opt.update(g, s_tree, p_tree)
        assert len(tree_leaves(g)) == len(tree_leaves(p_old)) == 3
        assert p_tree is not p_old                # update writes no input
        g_copy = tree_map(torch.clone, g)
        s_leaf = opt.apply(g_copy, s_leaf, p_leaf)
        assert tree_leaves(g_copy) == []          # every gradient popped
        for a, b in zip(tree_leaves(p_tree), tree_leaves(p_leaf)):
            assert torch.equal(a, b)
        for a, b in zip(_state_leaves(s_tree), _state_leaves(s_leaf)):
            assert torch.equal(a, b)


def _state_leaves(state):
    """sgd: (); momentum: a tree; adamw: AdamState(mu, nu, count)."""
    if isinstance(state, tuple):
        return [x for part in state for x in _state_leaves(part)]
    return tree_leaves(state)


def test_leafwise_update_frees_each_leaf_before_the_next():
    """While ``apply`` works on a leaf, the gradients and old values of
    the leaves before it are gone: the number of live old gradients falls
    by one a leaf, and no tensor the caller did not hand over is
    written."""
    from torch.overrides import TorchFunctionMode

    n = 4
    params = {f"l{i}": torch.randn(3, 8) for i in range(n)}
    grads = {f"l{i}": torch.randn(3, 8) for i in range(n)}
    kept = {k: v.clone() for k, v in params.items()}
    old_p = [weakref.ref(v) for v in params.values()]
    old_g = [weakref.ref(v) for v in grads.values()]
    alive = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            alive.append((sum(r() is not None for r in old_g),
                          sum(r() is not None for r in old_p)))
            return func(*args, **(kwargs or {}))

    opt = make_optimizer("sgd", 0.1)
    with Watch():
        opt.apply(grads, (), params)
    del grads
    assert sorted({a for a, _ in alive}, reverse=True) == list(
        range(n, 0, -1))
    assert sorted({b for _, b in alive}, reverse=True) == list(
        range(n, 0, -1))
    assert all(r() is None for r in old_p + old_g)
    for k in kept:
        assert not torch.equal(params[k], kept[k])


# -- a whole round through both Trainers ----------------------------------------

def test_trainer_round_with_remat_matches_jax():
    """gemma3 smoke with remat on both sides, float32 compute, p 2, tau 2,
    2 rounds: h, losses and theta (rtol 1e-5, atol 1e-6) and the params
    (atol 1e-5) of every round, as the quickstart test holds them."""
    jcfg, cfg = _cfgs("gemma3-1b")
    jp, axes = _jax_params("gemma3-1b")
    toks = make_tokens(0, 64, 33, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    wkw = dict(tau=2, beta=0.9, a_tilde=1.0, strategy="boltzmann")
    jtr = JTrainer(j_make_lm_loss(jcfg), jp, axes,
                   JTrainConfig(learning_rate=0.03, optimizer="sgd",
                                wasgd=JWASGDConfig(**wkw)), P, rule="wasgd")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ttr = Trainer(make_lm_loss(cfg), params, param_axes(params),
                  TrainConfig(learning_rate=0.03, optimizer="sgd",
                              wasgd=WASGDConfig(**wkw)), P, rule="wasgd",
                  device="cpu")
    for tr, ds in ((jtr, JOrderedDataset(data, P, 2, 2, n_segments=2)),
                   (ttr, OrderedDataset(data, P, 2, 2, n_segments=2))):
        tr.run(ds.batches(), 2, order_state=ds.order,
               segment_fn=ds.segment_of_round)
    for hj, ht in zip(jtr.history, ttr.history):
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6)
    jleaves = jax.tree.leaves(jtr.state.params)
    tleaves = tree_leaves(ttr.state.params)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
