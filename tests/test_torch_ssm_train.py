"""SSM training in the port against the JAX package: the SSD
``autograd.Function`` around ``ssd_chunk`` and mamba2's training forward,
loss, gradients and WASGD+ rounds, at the smoke sizes.

JAX trains SSM layers through its plain ``models/ssm.py::ssd_chunked``
(its Pallas ``ssd_chunk`` has no backward); the port's training forward
runs ``ssd_chunk`` (its plain version here, on the CPU) through
``SSDChunkFunction``, whose backward is the plain version's own. Inputs
come from numpy seeds; JAX runs on the CPU; both packages hold JAX's
weights.

Tolerances, float32: outputs and gradients 1e-5 relative to the largest
entry of each (the two packages sum in other orders: measured 3.7e-6 on
mamba2-smoke's gradients), losses 1e-5 relative; Trainer rounds as
``tests/test_torch_lm.py`` (h and losses rtol 1e-5, theta atol 1e-6,
params atol 1e-5); remat on and off bitwise.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import replicate_workers, worker_in_axes  # noqa: E402
from repro_torch.kernels.ssd_chunk import (SSDChunkFunction,  # noqa: E402
                                           ssd_chunk, ssd_chunk_ref,
                                           ssd_chunked_kernel)
from repro_torch.models import (loss_fn, param_axes,  # noqa: E402
                                params_from_numpy, ssd_chunked,
                                worker_losses)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.configs import WASGDConfig  # noqa: E402
from repro_torch.train import make_lm_loss  # noqa: E402
from repro_torch.train.step import _round_parts  # noqa: E402

from test_torch_moe import (_close_rel, _flat, assert_rounds_match,  # noqa: E402,E501
                            trainer_run)

ARCH = "mamba2-370m"
SSD_MOD = importlib.import_module("repro_torch.kernels.ssd_chunk.ssd_chunk")


def _cfgs(arch=ARCH, **kw):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32",
                               **kw)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32", **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    return j_init_params(jax_smoke(arch), jax.random.key(seed))


def _params(arch=ARCH, seed=0):
    jp, axes = _jax_params(arch, seed)
    return jp, axes, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _ssd_inputs(seed, b=2, s=48, nh=4, hd=8, ds=6, lead=()):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.normal(size=lead + (b, s, nh, hd)),
        0.01 + 0.3 * rng.random(lead + (b, s, nh)),
        -np.exp(2 * rng.random(lead + (nh,)) - 1),
        rng.normal(size=lead + (b, s, ds)),
        rng.normal(size=lead + (b, s, ds)))]


class _CountForward:
    """Counts the calls of the module's ``ssd_chunk`` (the kernel's
    launcher; its plain version here), as ``ssd_chunk.launches`` counts
    launches on the card."""

    def __enter__(self):
        self.calls = 0
        self._orig = SSD_MOD.ssd_chunk

        def counting(*args):
            self.calls += 1
            return self._orig(*args)

        SSD_MOD.ssd_chunk = counting
        return self

    def __exit__(self, *exc):
        SSD_MOD.ssd_chunk = self._orig


# -- the SSD Function --------------------------------------------------------------

@pytest.mark.parametrize("chunk,init", [(16, False), (8, True)])
def test_ssd_function_matches_jax_grad_of_ssd_chunked(chunk, init):
    """``ssd_chunked_kernel`` (the Function plus the plain inter-chunk
    recurrence) against JAX's plain ``ssd_chunked``: y and the final state,
    and the gradients of xs, dt, a, B, C (and the initial state) for fixed
    cotangents, against ``jax.grad``."""
    args = _ssd_inputs(1)
    rng = np.random.default_rng(2)
    init_state = rng.normal(size=(2, 4, 6, 8)).astype(np.float32) \
        if init else None
    wy = rng.normal(size=(2, 48, 4, 8)).astype(np.float32)
    ws = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    n = 6 if init else 5

    def j_obj(*a):
        y, st = JSSM.ssd_chunked(*a[:5], chunk,
                                 init_state=a[5] if init else None)
        return jnp.sum(y * wy) + jnp.sum(st * ws), (y, st)

    jin = [jnp.asarray(a) for a in args] + ([jnp.asarray(init_state)]
                                            if init else [])
    (_, (jy, jst)), jg = jax.jit(jax.value_and_grad(
        j_obj, argnums=tuple(range(n)), has_aux=True))(*jin)
    tin = [torch.from_numpy(a).requires_grad_() for a in args]
    tinit = torch.from_numpy(init_state).requires_grad_() if init else None
    with _CountForward() as count:
        y, st = ssd_chunked_kernel(*tin, chunk, init_state=tinit)
    assert count.calls == 1
    ((y * torch.from_numpy(wy)).sum()
     + (st * torch.from_numpy(ws)).sum()).backward()
    _close_rel(y.detach().numpy(), jy, 1e-5, "y")
    _close_rel(st.detach().numpy(), jst, 1e-5, "state")
    got = [t.grad for t in tin] + ([tinit.grad] if init else [])
    for name, g, r in zip(("xs", "dt", "a", "B", "C", "init"), got, jg):
        _close_rel(g.numpy(), r, 1e-5, name)


def test_ssd_function_backward_is_the_plain_versions():
    """The Function's gradients equal autograd through ``ssd_chunk_ref``
    on the same inputs (bf16 xs, B, C as the model gives them), and only
    the forward calls the launcher."""
    rng = np.random.default_rng(3)
    xs, dt, a, B, C = (torch.from_numpy(v) for v in _ssd_inputs(3, s=32))
    shaped = [xs.reshape(2, 2, 16, 4, 8).bfloat16(), dt.reshape(2, 2, 16, 4),
              a, B.reshape(2, 2, 16, 6).bfloat16(),
              C.reshape(2, 2, 16, 6).bfloat16()]
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((2, 2, 16, 4, 8), (2, 2, 4, 6, 8), (2, 2, 4))]
    leaves = [t.clone().requires_grad_() for t in shaped]
    with _CountForward() as count:
        outs = SSDChunkFunction.apply(*leaves)
        grads = torch.autograd.grad(outs, leaves, cot)
    assert count.calls == 1
    ref_leaves = [t.clone().requires_grad_() for t in shaped]
    ref = torch.autograd.grad(ssd_chunk_ref(*ref_leaves), ref_leaves, cot)
    for g, r, t in zip(grads, ref, shaped):
        assert g.dtype == t.dtype
        assert torch.equal(g, r)


def test_ssd_function_vmap_with_per_worker_a_matches_a_loop():
    """The round's form: ``vmap`` over 3 workers, each with its own decay
    rates ``a`` (A_log is a worker leaf). One forward call for all
    workers (the kernel takes ``a`` one row a batch row); outputs and
    every gradient equal a loop over workers of the plain ``ssd_chunked``."""
    args = [torch.from_numpy(v) for v in _ssd_inputs(4, lead=(3,))]
    leaves = [t.clone().requires_grad_() for t in args]
    with _CountForward() as count:
        y, st = torch.func.vmap(
            lambda *t: ssd_chunked_kernel(*t, 16))(*leaves)
    assert count.calls == 1
    obj = (y * y.detach().sin()).sum() + (st * st.detach().cos()).sum()
    grads = torch.autograd.grad(obj, leaves)
    ref_leaves = [t.clone().requires_grad_() for t in args]
    outs = [ssd_chunked(*(t[w] for t in ref_leaves), 16) for w in range(3)]
    ry = torch.stack([o[0] for o in outs])
    rst = torch.stack([o[1] for o in outs])
    np.testing.assert_allclose(y.detach().numpy(), ry.detach().numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.detach().numpy(), rst.detach().numpy(),
                               rtol=0, atol=1e-6)
    rgrads = torch.autograd.grad(
        (ry * y.detach().sin()).sum() + (rst * st.detach().cos()).sum(),
        ref_leaves)
    for name, g, r in zip(("xs", "dt", "a", "B", "C"), grads, rgrads):
        _close_rel(g.numpy(), r.numpy(), 1e-5, name)


def test_ssd_chunk_takes_a_row_of_decay_rates_per_batch_row():
    """``a`` (b, nh) equals b calls with their own (nh,) rows; the launch
    path's check takes both shapes and no other."""
    xs, dt, a, B, C = (torch.from_numpy(v) for v in
                       _ssd_inputs(5, s=32, hd=32, ds=8))
    shaped = (xs.reshape(2, 2, 16, 4, 32), dt.reshape(2, 2, 16, 4),
              B.reshape(2, 2, 16, 8), C.reshape(2, 2, 16, 8))
    rows = torch.stack([a, 2 * a])
    out = ssd_chunk(shaped[0], shaped[1], rows, *shaped[2:])
    for i in range(2):
        one = ssd_chunk(*(t[i:i + 1] for t in shaped[:2]), rows[i],
                        *(t[i:i + 1] for t in shaped[2:]))
        for o, r in zip(out, one):
            assert torch.equal(o[i:i + 1], r)
    SSD_MOD._check(*(t.contiguous() for t in shaped[:2]), rows,
                   *shaped[2:])
    with pytest.raises(ValueError, match="agree in shape"):
        SSD_MOD._check(shaped[0], shaped[1], torch.zeros(3, 4), *shaped[2:])


# -- mamba2 training ------------------------------------------------------------------

def _batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_mamba2_loss_and_gradients_match_jax():
    jcfg, cfg = _cfgs()
    jp, _, tp = _params(seed=1)
    batch = _batch(cfg, 1, s=40)       # 40 tokens: a padded chunk tail
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    with _CountForward() as count:
        tg, (tl, taux) = torch.func.grad_and_value(
            lambda p: loss_fn(cfg, p, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}),
            has_aux=True)(tp)
    assert count.calls == cfg.n_layers
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(taux["moe_loss"]) == float(jaux["moe_loss"]) == 0.0
    ft, fj = _flat(tg), _flat(jg)
    assert sorted(ft) == sorted(fj)
    for k in fj:
        _close_rel(ft[k], fj[k], 1e-5, k)


def _stacked(cfg, tp, p=3, seed=2):
    """``tp`` on p workers, each worker's A_log and in_proj moved apart so
    the workers differ (and so do their decay rates)."""
    params, axes = replicate_workers(tp, param_axes(tp), p)
    gen = torch.Generator().manual_seed(seed)
    for lp in params["layers"].values():
        if "ssm" not in lp:
            continue
        for name in ("A_log", "in_proj"):
            x = lp["ssm"][name]
            lp["ssm"][name] = x + 0.1 * torch.randn(x.shape, generator=gen)
    return params, axes


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_worker_losses_match_jax_vmap_of_loss_fn(arch):
    """The round's worker-stacked loss against ``jax.vmap`` of JAX's
    ``loss_fn`` over the same per-worker params and batches (mamba2, and
    the hybrid jamba, whose expert leaves are one copy for all workers)."""
    jcfg, cfg = _cfgs(arch)
    _, _, tp = _params(arch, seed=3)
    params, axes = _stacked(cfg, tp)
    in_dims = worker_in_axes(axes)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (3, 2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    losses, aux = worker_losses(cfg, params, in_dims,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    j_in = jax.tree.map(lambda d: 0 if d == 0 else None, in_dims,
                        is_leaf=lambda d: d is None or isinstance(d, int))
    jl, jaux = jax.vmap(lambda p, b: j_loss_fn(jcfg, p, b),
                        in_axes=(j_in, 0))(jparams,
                                           jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(aux["moe_loss"].numpy(),
                               np.asarray(jaux["moe_loss"]), rtol=1e-5,
                               atol=1e-12)


def _round_grads(cfg, params, axes, mb):
    parts = _round_parts(make_lm_loss(cfg), make_optimizer("sgd", 0.1), axes,
                         WASGDConfig(tau=1), 3)
    return parts.worker_grads(params, mb)


def test_remat_on_and_off_agree_bitwise_and_launch_twice():
    """One local step of the round with ``remat`` off and on: the same
    losses and gradients bit for bit; with remat each SSM layer's forward
    (the ``ssd_chunk`` call) runs again in the backward pass, and the
    vmapped step calls it once per layer per pass, not once per worker."""
    _, cfg = _cfgs()
    _, _, tp = _params(seed=4)
    params, axes = _stacked(cfg, tp, seed=4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 2, 33))
    mb = {"tokens": torch.from_numpy(toks[..., :-1].astype(np.int32)),
          "labels": torch.from_numpy(toks[..., 1:].astype(np.int32))}
    out, calls = {}, {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        with _CountForward() as count:
            out[remat] = _round_grads(c, params, axes, mb)
        calls[remat] = count.calls
    assert calls == {False: cfg.n_layers, True: 2 * cfg.n_layers}
    (g0, l0), (g1, l1) = out[False], out[True]
    assert torch.equal(l0, l1)
    f0, f1 = _flat(g0), _flat(g1)
    for k in f0:
        np.testing.assert_array_equal(f1[k], f0[k], err_msg=k)


def test_mamba2_trainer_matches_jax_round_by_round():
    """mamba2-smoke through both Trainers, WASGD+ (p 2, tau 2, b_local 2,
    seq 32): h, theta, losses and params every round."""
    jcfg, cfg = _cfgs()
    jp, axes, _ = _params(seed=5)
    jp = jax.tree.map(np.asarray, jp)
    tr_j, snaps_j = trainer_run("jax", jcfg, cfg, jp, axes)
    with _CountForward() as count:
        tr_t, snaps_t = trainer_run("port", jcfg, cfg, jp, axes)
    assert_rounds_match(tr_j, snaps_j, tr_t, snaps_t)
    # the round's local steps: one ssd_chunk call per SSM layer a step
    # (remat off in the smoke config)
    from test_torch_moe import ROUNDS, TAU
    assert count.calls == ROUNDS * TAU * cfg.n_layers
