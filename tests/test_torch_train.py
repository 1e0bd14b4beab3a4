"""The port's synchronous WASGD+ training slice against the JAX package.

The round-level tests run the paper's MLP and CNN6 on the harness of
``benchmarks/common.py`` (its models, data, OrderedDataset and trainer
settings) through the JAX ``Trainer`` and the port's ``Trainer``, both
with ``backend="pallas_wagg:f32"`` (JAX's Pallas kernel in interpret mode,
the port's plain version of its CUDA kernel), from the same JAX-initialized
parameters, and compare every round: energies h, theta, loss and all
parameters. The dataset is the harness's, cut to its first 512 samples so
that OrderGen's keep-or-reshuffle decision fires inside the run; the
decisions must be identical.

Tolerances (float32; the port takes each worker's gradient of its own
loss where JAX scales the gradient of the mean by p, and sums in other
orders, so the trajectories drift apart by rounding only):
  MLP, 10 rounds: params atol 1e-5, h/loss rtol 1e-5, theta atol 1e-6,
    Judge scores (z-scores of order one) atol 1e-4; measured worst on this
    CPU: params 1.8e-7, h 1.3e-6 relative, theta 3.0e-8, scores 2.2e-5.
  CNN6, 3 rounds: the model amplifies rounding (see its test), so params
    are held to twice JAX's own spread under a 1e-7 perturbation of its
    start, loss rtol 1e-4 (measured 5.6e-5), theta atol 1e-5 (3.3e-6).
"""
import os
import subprocess
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
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.data import make_classification as j_make_classification  # noqa: E402
from repro.data import make_images as j_make_images  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.step import _round_parts as j_round_parts  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.data import (OrderedDataset, make_classification,  # noqa: E402
                              make_images)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.wagg import wagg_fused  # noqa: E402
from repro_torch.models import (classification_loss, cnn6_apply,  # noqa: E402
                                cnn6_from_jax, cnn6_to_jax, init_cnn6,
                                init_mlp, mlp_apply, params_from_numpy)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import HotSwapBridge  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.step import _round_parts  # noqa: E402

P, TAU, B_LOCAL, N_SAMPLES = 4, 8, 8, 512


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _port_loss(apply_fn):
    def loss_fn(params, batch):
        return classification_loss(apply_fn(params, batch["x"]),
                                   batch["y"]), {}
    return loss_fn


def _recorded_run(tr, ds, rounds, snap):
    """``tr.run`` over ``ds`` for ``rounds`` rounds, recording the params
    after every round and every OrderGen decision (segment, scores, keep)."""
    snaps, decisions = [], []
    step, end = tr._step, ds.order.end_segment

    def recording_step(state, batch):
        out = step(state, batch)
        snaps.append(snap(out[0].params))
        return out

    def recording_end(segment):
        scores = ds.order.scores[segment].copy()
        decisions.append((segment, scores, end(segment).copy()))
        return decisions[-1][2]

    tr._step, ds.order.end_segment = recording_step, recording_end
    tr.run(ds.batches(), rounds, order_state=ds.order,
           segment_fn=ds.segment_of_round)
    return snaps, decisions


def _run(framework, images, rounds, perturb=0.0, lr=0.05):
    """The harness's run (``benchmarks/common.py``: its model, data cut to
    N_SAMPLES, OrderedDataset and trainer settings) through one Trainer,
    from JAX's initial params plus ``perturb`` times seeded noise."""
    params_j, axes, loss_j, _ = common.model(0, images)
    X, y = common.dataset(0, images)
    data = {"x": X[:N_SAMPLES], "y": y[:N_SAMPLES]}
    rng = np.random.default_rng(1)
    start = jax.tree.map(lambda v: np.asarray(v) + perturb * rng.normal(
        size=v.shape).astype(np.float32), params_j)
    wkw = dict(tau=TAU, beta=0.9, a_tilde=1.0, strategy="boltzmann",
               backend="pallas_wagg:f32")
    if framework == "jax":
        tr = JTrainer(loss_j, jax.tree.map(jnp.asarray, start), axes,
                      JTrainConfig(learning_rate=lr, optimizer="sgd",
                                   wasgd=JWASGDConfig(**wkw)), P,
                      rule="wasgd+")
        ds = JOrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7)
        snap = _np_tree
    else:
        start = (cnn6_from_jax(start, device="cpu") if images
                 else params_from_numpy(start, device="cpu"))
        tr = Trainer(_port_loss(cnn6_apply if images else mlp_apply), start,
                     axes, TrainConfig(learning_rate=lr, optimizer="sgd",
                                       wasgd=WASGDConfig(**wkw)), P,
                     rule="wasgd+", device="cpu")
        ds = OrderedDataset(data, P, TAU, B_LOCAL, n_segments=2, seed=7)
        snap = (cnn6_to_jax if images else
                (lambda t: {k: v.numpy().copy() for k, v in t.items()}))
    snaps, decisions = _recorded_run(tr, ds, rounds, snap)
    return tr, snaps, decisions


def _max_dev(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def test_mlp_trainer_matches_jax_round_by_round():
    """10 rounds; OrderGen decides at rounds 4 and 8."""
    tr_j, snaps_j, dec_j = _run("jax", False, 10)
    tr_t, snaps_t, dec_t = _run("port", False, 10)
    for r, (hj, ht) in enumerate(zip(tr_j.history, tr_t.history)):
        for k in ("h", "loss", "loss_last"):
            np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"round {r} {k}")
        for k, atol in (("theta", 1e-6), ("scores", 1e-4)):
            np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=atol,
                                       err_msg=f"round {r} {k}")
        assert _max_dev(snaps_t[r], snaps_j[r]) <= 1e-5, f"round {r}"
    assert len(tr_t.history) == 10 and tr_t.losses()[-1] < tr_t.losses()[0]
    assert [d[0] for d in dec_t] == [d[0] for d in dec_j] == [0, 1]
    for (_, sc_t, keep_t), (_, sc_j, keep_j) in zip(dec_t, dec_j):
        np.testing.assert_array_equal(keep_t, keep_j)
        np.testing.assert_allclose(sc_t, sc_j, rtol=0, atol=1e-4)
    # the decisions are robust: every accumulated score lies at least
    # 0.38 from keep_score = -1, the two packages' scores within 2.2e-5
    assert min(float(np.abs(sc + 1.0).min()) for _, sc, _ in dec_j) > 0.1


def test_cnn6_trainer_matches_jax_within_its_own_spread():
    """3 rounds from JAX's converted params. CNN6 at lr 0.05 amplifies
    float rounding: JAX's own run started 1e-7 away moves its params by
    1.1e-5, 2.7e-4 and 5.3e-4 in rounds 0-2. The port must stay within
    twice that spread of JAX's run in every round (measured: 4.5e-8,
    1.1e-4, 4.2e-4)."""
    tr_j, snaps_j, _ = _run("jax", True, 3)
    _, snaps_e, _ = _run("jax", True, 3, perturb=1e-7)
    tr_t, snaps_t, _ = _run("port", True, 3)
    for r in range(3):
        spread = _max_dev(snaps_e[r], snaps_j[r])
        assert _max_dev(snaps_t[r], snaps_j[r]) <= 2 * spread + 1e-6, r
        hj, ht = tr_j.history[r], tr_t.history[r]
        np.testing.assert_allclose(ht["theta"], hj["theta"], rtol=0,
                                   atol=1e-5, err_msg=f"round {r} theta")
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-4,
                                   err_msg=f"round {r} loss")
    assert tr_t.losses()[-1] < tr_t.losses()[0]


def test_kernel_wrapper_counts_nothing_on_the_cpu():
    before = wagg_fused.launches
    params = init_mlp(0, 8, 16, 3, device="cpu")
    X, y = make_classification(1, 64, d=8, n_classes=3)
    tr = Trainer(_port_loss(mlp_apply), params,
                 {k: (None,) * v.dim() for k, v in params.items()},
                 TrainConfig(learning_rate=0.1, wasgd=WASGDConfig(
                     tau=2, backend="pallas_wagg:f32")), 2, device="cpu")
    tr.run(OrderedDataset({"x": X, "y": y}, 2, 2, 4), 3)
    assert wagg_fused.launches == before
    assert np.isfinite(tr.losses()).all()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_is_the_jax_packages():
    for ours, ref in ((make_classification(3, 200, d=16, noise=0.25),
                       j_make_classification(3, 200, d=16, noise=0.25)),
                      (make_images(2, 50), j_make_images(2, 50))):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ordered_dataset_batches_are_the_jax_packages():
    X, y = make_images(0, 320)
    ours = OrderedDataset({"x": X, "y": y}, 3, 2, 5, n_segments=2, seed=4)
    ref = JOrderedDataset({"x": X, "y": y}, 3, 2, 5, n_segments=2, seed=4)
    assert ours.rounds_per_segment == ref.rounds_per_segment == 16
    gen_o, gen_r = ours.batches(), ref.batches()
    rng = np.random.default_rng(0)
    for r in range(40):                  # two decisions per segment
        bo, br = next(gen_o), next(gen_r)
        for k in bo:
            np.testing.assert_array_equal(bo[k], br[k])
        s = rng.normal(size=3)
        ours.order.record_scores(ours.segment_of_round(r), s)
        ref.order.record_scores(ref.segment_of_round(r), s)
    np.testing.assert_array_equal(ours.order.seeds, ref.order.seeds)


# ---------------------------------------------------------------------------
# models and optimizers
# ---------------------------------------------------------------------------

def test_cnn6_logits_match_jax_and_the_flatten_trap_shows():
    """With the converted params the logits agree within 1e-5; converting
    the conv weights but not the rows of fc_w (torch's (c, h, w) flatten
    against JAX's (h, w, c)) gives other logits."""
    pj = jcnn.init_cnn6(jax.random.key(3))
    X, _ = make_images(1, 16)
    ref = np.asarray(jcnn.cnn6_apply(pj, jnp.asarray(X)))
    pt = cnn6_from_jax(_np_tree(pj), device="cpu")
    ours = cnn6_apply(pt, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    wrong = dict(pt, fc_w=torch.from_numpy(np.asarray(pj["fc_w"])))
    assert np.abs(cnn6_apply(wrong, torch.from_numpy(X)).numpy()
                  - ref).max() > 1e-2
    back = cnn6_to_jax(pt)
    for k in pj:
        np.testing.assert_array_equal(back[k], np.asarray(pj[k]))


def test_mlp_logits_and_loss_match_jax():
    from repro.models.param import build
    import functools
    pj, _ = build(functools.partial(jcnn.mlp_init, d_in=12, d_hidden=20,
                                    n_classes=5, n_hidden_layers=3),
                  jax.random.key(0))
    X, y = make_classification(0, 30, d=12, n_classes=5)
    ref = jcnn.mlp_apply(pj, jnp.asarray(X))
    ours = mlp_apply(params_from_numpy(_np_tree(pj), device="cpu"),
                     torch.from_numpy(X))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        classification_loss(ours, torch.from_numpy(y)).numpy(),
        jcnn.classification_loss(ref, jnp.asarray(y)), rtol=1e-6)


def test_port_init_has_the_jax_shapes_and_scales():
    pj = jcnn.init_cnn6(jax.random.key(0))
    pt = init_cnn6(0, device="cpu")
    back = cnn6_to_jax(pt)
    for k in pj:
        assert back[k].shape == pj[k].shape
        assert abs(back[k].std() - float(jnp.std(pj[k]))) <= \
            0.25 * float(jnp.std(pj[k])) + 1e-12
    assert sorted(init_mlp(0, 64, 128, 10, device="cpu")) == \
        sorted(common.model(0)[0])


@pytest.mark.parametrize("name, kw", [("sgd", {}),
                                      ("sgd", {"weight_decay": 0.01}),
                                      ("momentum", {"momentum": 0.9}),
                                      ("adamw", {"weight_decay": 0.01})])
def test_optimizers_match_jax(name, kw):
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    ours, ref = make_optimizer(name, 0.05, **kw), \
        j_make_optimizer(name, 0.05, **kw)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    st_t, st_j = ours.init(pt), ref.init(pj)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        pt, st_t = ours.update({k: torch.from_numpy(v) for k, v in g.items()},
                               st_t, pt)
        pj, st_j = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                              st_j, pj)
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0,
                                   atol=1e-6)


def test_round_parts_reshape_worker_major_and_l2_like_jax():
    """(p, tau, b_local) worker-major, then (tau, p, ...): reversing it
    would hand each worker other samples and still train."""
    axes = {"w": ("worker", None), "s": (None,)}
    wcfg_t, wcfg_j = WASGDConfig(tau=3), JWASGDConfig(tau=3)
    parts_t = _round_parts(lambda p, b: (p["w"].sum(), {}),
                           make_optimizer("sgd"), axes, wcfg_t, 2)
    parts_j = j_round_parts(lambda p, b: (p["w"].sum(), {}),
                            j_make_optimizer("sgd"), axes, wcfg_j, 2)
    batch = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(24, 2)
    ours = parts_t.reshape_batch({"x": torch.from_numpy(batch)})["x"]
    ref = parts_j.reshape_batch({"x": jnp.asarray(batch)})["x"]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours[1, 0].numpy(), batch[4:8])
    np.testing.assert_array_equal(parts_t.mask, np.asarray(parts_j.mask))
    rng = np.random.default_rng(2)
    a = {"w": rng.normal(size=(2, 6)).astype(np.float32),
         "s": rng.normal(size=(3,)).astype(np.float32)}
    b = {k: v + 1 for k, v in a.items()}
    for args in ((a,), (a, b)):
        np.testing.assert_allclose(
            parts_t.worker_l2(*[{k: torch.from_numpy(v) for k, v in t.items()}
                                for t in args]).numpy(),
            parts_j.worker_l2(*[{k: jnp.asarray(v) for k, v in t.items()}
                                for t in args]), rtol=1e-6)


# ---------------------------------------------------------------------------
# entry points and the import rule
# ---------------------------------------------------------------------------

def test_entry_points_without_a_card_raise(monkeypatch):
    """``device=None`` means cuda: with no card every entry point of the
    training slice raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_mlp(0, 4, 8, 2, device="cpu")
    axes = {k: (None,) * v.dim() for k, v in params.items()}
    for call in (lambda: resolve_device(None),
                 lambda: init_cnn6(0),
                 lambda: init_mlp(0, 4, 8, 2),
                 lambda: cnn6_from_jax({"fc_b": np.zeros(3, np.float32)}),
                 lambda: Trainer(_port_loss(mlp_apply), params, axes,
                                 TrainConfig(), 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


_IMPORT_PROBE = """
import sys
import repro_torch, repro_torch.configs, repro_torch.core, repro_torch.data
import repro_torch.kernels.build, repro_torch.kernels.wagg
import repro_torch.models, repro_torch.optim, repro_torch.train
import repro_torch.checkpoint, repro_torch.train.evaluate
import repro_torch.core.async_sim, repro_torch.core.async_device
import repro_torch.core.membership
import repro_torch.obs, repro_torch.data.pipeline
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""


def test_training_slice_imports_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
