"""The paper's baseline rules in the port against the JAX package.

Each rule (SimuParallelSGD, EASGD at its default and at an overridden
alpha, OMWU, MMWU and sequential SGD) runs the MLP of the harness in
``benchmarks/common.py`` (its model and data, cut to 512 samples; an
OrderedDataset of 2 segments) for 10 rounds through the JAX ``Trainer``
and the port's ``Trainer`` from JAX's initial params, and every round is
held with the wasgd MLP test's tolerances (``test_torch_train.py``):
params atol 1e-5, h and loss rtol 1e-5, theta atol 1e-6. The rules' own
state is held too: EASGD's center (atol 1e-5, as the params) and the MWU
log-weights (rtol 1e-5). Measured worst on this CPU over the six runs:
params 1.2e-7, h/loss 3.0e-7 relative, theta 0 (every MWU argmax the
same).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import common  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.core import baselines as jbl  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.train import RULES as J_RULES  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.data import OrderedDataset  # noqa: E402
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.train import RULES, Trainer  # noqa: E402

P, TAU, B_LOCAL, N_SAMPLES, ROUNDS = 4, 8, 8, 512, 10


def _port_loss(params, batch):
    return classification_loss(mlp_apply(params, batch["x"]),
                               batch["y"]), {}


def _run(framework, rule, easgd_alpha=None):
    """The harness's MLP run of ``rule`` through one Trainer; returns the
    trainer and the params after every round as numpy trees."""
    params_j, axes, loss_j, _ = common.model(0)
    X, y = common.dataset(0)
    data = {"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}
    wkw = dict(tau=TAU, beta=0.9, a_tilde=1.0, strategy="boltzmann")
    if framework == "jax":
        tr = JTrainer(loss_j, params_j, axes,
                      JTrainConfig(learning_rate=0.05, optimizer="sgd",
                                   wasgd=JWASGDConfig(**wkw)), P, rule=rule,
                      easgd_alpha=easgd_alpha)
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7)
        snap = lambda t: jax.tree.map(lambda v: np.array(v), t)  # noqa: E731
    else:
        start = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                  device="cpu")
        tr = Trainer(_port_loss, start, axes,
                     TrainConfig(learning_rate=0.05, optimizer="sgd",
                                 wasgd=WASGDConfig(**wkw)), P, rule=rule,
                     device="cpu", easgd_alpha=easgd_alpha)
        ds = OrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7)
        snap = lambda t: {k: v.numpy().copy() for k, v in t.items()}  # noqa: E731
    snaps, step = [], tr._step

    def recording_step(state, batch):
        out = step(state, batch)
        snaps.append(snap(out[0].params))
        return out

    tr._step = recording_step
    tr.run(ds, ROUNDS)
    return tr, snaps


def test_the_port_has_jaxs_rules():
    assert sorted(RULES) == sorted(J_RULES)


@pytest.mark.parametrize("rule, alpha", [
    ("spsgd", None), ("easgd", None), ("easgd", 0.3), ("omwu", None),
    ("mmwu", None), ("seq", None),
], ids=["spsgd", "easgd", "easgd_alpha", "omwu", "mmwu", "seq"])
def test_baseline_rule_matches_jax_round_by_round(rule, alpha):
    tr_j, snaps_j = _run("jax", rule, alpha)
    tr_t, snaps_t = _run("port", rule, alpha)
    assert len(tr_t.history) == ROUNDS
    for r, (hj, ht) in enumerate(zip(tr_j.history, tr_t.history)):
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"round {r} {k}")
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-6, err_msg=f"round {r} theta")
        for k in snaps_j[r]:
            np.testing.assert_allclose(snaps_t[r][k], snaps_j[r][k], rtol=0,
                                       atol=1e-5, err_msg=f"round {r} {k}")
    cs_j, cs_t = tr_j.state.comm_state, tr_t.state.comm_state
    if rule == "easgd":
        assert isinstance(cs_t, bl.EASGDState)
        for k in cs_j.center:
            np.testing.assert_allclose(cs_t.center[k].numpy(),
                                       np.asarray(cs_j.center[k]), rtol=0,
                                       atol=1e-5, err_msg=k)
    elif rule in ("omwu", "mmwu"):
        assert isinstance(cs_t, bl.MWUState)
        np.testing.assert_allclose(cs_t.log_w.numpy(),
                                   np.asarray(cs_j.log_w), rtol=1e-5)
        assert all(np.count_nonzero(h["theta"]) == 1 for h in tr_t.history)
    else:
        assert cs_t == cs_j == ()
    if rule == "seq":               # the workers never talk
        assert max(float(np.abs(v[0] - v[1]).max())
                   for v in snaps_t[-1].values()) > 1e-3


def test_easgd_alpha_overrides_the_default():
    """The default alpha is 0.9/16, as JAX's; ``easgd_alpha=`` replaces it
    (the run differs from the default one), and the pull moves the center
    by the sum of the workers' pulls."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(P, 5)).astype(np.float32)
    c = rng.normal(size=(5,)).astype(np.float32)
    axes = {"w": ("worker", None)}
    for alpha in (0.9 / 16, 0.3):
        (pt, st), (pj, sj) = (
            bl.easgd_communicate({"w": torch.from_numpy(x)}, axes,
                                 bl.EASGDState({"w": torch.from_numpy(c)}),
                                 alpha),
            jbl.easgd_communicate({"w": jnp.asarray(x)}, axes,
                                  jbl.EASGDState({"w": jnp.asarray(c)}),
                                  alpha))
        np.testing.assert_allclose(pt["w"].numpy(), np.asarray(pj["w"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(st.center["w"].numpy(),
                                   np.asarray(sj.center["w"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(st.center["w"].numpy() - c,
                                   alpha * (x - c).sum(0), rtol=0, atol=1e-5)
    X, y = common.dataset(0)
    params = params_from_numpy(jax.tree.map(np.asarray, common.model(0)[0]),
                               device="cpu")
    axes = {k: (None,) * v.dim() for k, v in params.items()}
    cfg = TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(tau=2))
    out = {}
    for alpha in (None, 0.9 / 16, 0.5):
        tr = Trainer(_port_loss, params, axes, cfg, 2, rule="easgd",
                     device="cpu", easgd_alpha=alpha)
        tr.run(iter([{"x": X[:32], "y": y[:32]}]), 1)
        out[alpha] = tr.state.comm_state.center
    for k in params:
        assert torch.equal(out[None][k], out[0.9 / 16][k])
    assert any(not torch.equal(out[None][k], out[0.5][k]) for k in params)
