"""From training to serving in the port, against the JAX package: the
served consensus, held-out evaluation, the hot-swap bridge between a
``Trainer`` and a running ``ContinuousEngine``, the run's metrics JSONL
and the optimizer helpers.

Tolerances (float32): ``consensus_params`` atol 1e-6 (a mean of p values
summed in another order); ``evaluate_lm`` nll and ppl rtol 1e-5 (logits
held to 1e-5 in ``test_torch_lm.py``), accuracy exact; the bridge's swap
records: counts exact, drift rtol 1e-5 (the trainers agree to rounding,
``test_torch_lm.py``); metrics lines: the MLP run's tolerances of
``test_torch_train.py`` (h/loss rtol 1e-5, theta atol 1e-6, Judge
scores atol 1e-4); the optimizer helpers rtol 1e-6.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import replicate_workers as j_replicate  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.param import build  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.serve import ContinuousEngine as JEngine  # noqa: E402
from repro.serve import HotSwapBridge as JBridge  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.evaluate import consensus_params as j_consensus  # noqa: E402
from repro.train.evaluate import evaluate_lm as j_evaluate  # noqa: E402
from repro.train.lm import make_lm_loss as j_make_lm_loss  # noqa: E402
from repro_torch.configs import (TrainConfig, WASGDConfig,  # noqa: E402
                                 get_smoke_config)
from repro_torch.core import replicate_workers  # noqa: E402
from repro_torch.data import OrderedDataset, lm_batch, make_tokens  # noqa: E402
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import (clip_by_global_norm, global_norm,  # noqa: E402
                               lr_schedule)
from repro_torch.serve import ContinuousEngine, HotSwapBridge  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.train.evaluate import (consensus_params,  # noqa: E402
                                        evaluate_lm)

ARCH = "stablelm-1.6b"


def _cfgs():
    return (dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32"),
            dataclasses.replace(get_smoke_config(ARCH),
                                compute_dtype="float32"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tree.numpy() if isinstance(tree, torch.Tensor)
                     else np.asarray(tree))}


def test_consensus_params_matches_jax():
    """Worker-stacked stablelm smoke params (each worker moved apart),
    and one shared leaf: the beta=1 equal aggregate's row 0."""
    jcfg, _ = _cfgs()
    params, axes = j_init_params(jcfg, jax.random.key(1))
    wp, waxes = j_replicate(params, axes, 3)
    rng = np.random.default_rng(0)
    wp = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(
        size=x.shape).astype(np.float32)) * 0.01, wp)
    wp["shared"], waxes["shared"] = jnp.arange(5.0), (None,)
    ref = _flat(_np(j_consensus(wp, waxes)))
    ours = _flat(consensus_params(params_from_numpy(_np(wp), device="cpu"),
                                  waxes))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    single = {"w": torch.ones(2)}
    assert consensus_params(single, {"w": (None,)}) is single


def test_evaluate_lm_matches_jax():
    jcfg, cfg = _cfgs()
    params, _ = j_init_params(jcfg, jax.random.key(2))
    held = make_tokens(999, 24, 33, cfg.vocab_size)

    def batches():
        i = 0
        while True:
            sl = held[(i * 4) % 20:(i * 4) % 20 + 4]
            yield {"tokens": sl[:, :-1], "labels": sl[:, 1:]}
            i += 1

    ref = j_evaluate(jcfg, params, batches(), n_batches=3)
    ours = evaluate_lm(cfg, params_from_numpy(_np(params), device="cpu"),
                       batches(), n_batches=3)
    assert sorted(ours) == ["acc", "nll", "ppl"]
    for k in ("nll", "ppl"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)
    assert ours["acc"] == ref["acc"]


def _hot_swap_run(framework):
    """``test_serve_continuous.py::test_hot_swap_keeps_in_flight_requests_
    alive`` through one package: a request in flight while the trainer
    swaps its consensus in every 2 rounds."""
    jcfg, cfg = _cfgs()
    params, axes = j_init_params(jcfg, jax.random.key(7))
    prompt = np.asarray(j_lm_batch(7, 1, 8, cfg.vocab_size)["tokens"])[0]
    if framework == "jax":
        tr = JTrainer(j_make_lm_loss(jcfg), params, axes, JTrainConfig(
            learning_rate=0.05, optimizer="sgd",
            wasgd=JWASGDConfig(tau=2, beta=0.9)), 2)
        eng = JEngine(jcfg, params, n_slots=2, max_len=64, block_size=8,
                      cache_dtype=jnp.float32, chunk=4)
        bridge = JBridge(eng)
    else:
        tp = params_from_numpy(_np(params), device="cpu")
        tr = Trainer(make_lm_loss(cfg), tp, axes, TrainConfig(
            learning_rate=0.05, optimizer="sgd",
            wasgd=WASGDConfig(tau=2, beta=0.9)), 2, device="cpu")
        eng = ContinuousEngine(cfg, tp, n_slots=2, max_len=64, block_size=8,
                               cache_dtype=torch.float32, chunk=4,
                               device="cpu")
        bridge = HotSwapBridge(eng)
    rid = eng.submit(prompt, n_new=40)
    eng.step()
    assert eng.n_running == 1

    def hook(r, p, a):
        eng.step()                       # serve between training rounds
        bridge(r, p, a)

    def batches():
        r = 0
        while True:
            yield lm_batch(r, 4, 16, cfg.vocab_size)
            r += 1

    tr.run(batches(), 4, serve_hook=hook, serve_every=2)
    done = eng.run()
    return bridge.swaps, done[rid], eng


def test_hot_swap_keeps_in_flight_requests_alive_as_jax():
    ref, _, _ = _hot_swap_run("jax")
    swaps, tokens, eng = _hot_swap_run("port")
    assert len(tokens) == 40             # the request survived both swaps
    assert eng.n_swaps == 2 and len(swaps) == 2
    first, second = swaps
    assert first["in_flight"] == 1 and second["in_flight"] == 1
    assert first["rounds_since_last"] is None
    assert second["rounds_since_last"] == 2
    assert second["param_drift_l2"] > 0 and second["tokens_under_prev"] > 0
    for ours, theirs in zip(swaps, ref):
        assert sorted(ours) == sorted(theirs)
        for k in ("round", "rounds_since_last", "tokens_under_prev",
                  "in_flight"):
            assert ours[k] == theirs[k], k
        np.testing.assert_allclose(ours["param_drift_l2"],
                                   theirs["param_drift_l2"], rtol=1e-5)


def test_bridge_drift_is_measured_against_what_the_engine_was_given():
    """A bfloat16 engine handed float32 params keeps them as given: a swap
    of the same params closes a drift of 0, the float32 distance from
    them, though the engine's bfloat16 copy lies away from them."""
    jcfg, cfg = _cfgs()
    params, axes = j_init_params(jcfg, jax.random.key(3))
    tp = params_from_numpy(_np(params), device="cpu")
    eng = ContinuousEngine(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           tp, n_slots=1, max_len=32, block_size=8,
                           device="cpu")
    assert eng.given_params is tp
    rec = HotSwapBridge(eng)(0, *replicate_workers(tp, axes, 2))
    assert rec["param_drift_l2"] == 0.0 and eng.n_swaps == 1
    assert HotSwapBridge._drift(eng.params, tp) > 0


def _mlp_metrics_run(framework, path):
    params, axes = build(lambda b: jcnn.mlp_init(b, 8, 16, 4),
                         jax.random.key(0))
    X, y = np.random.default_rng(0).normal(size=(256, 8)).astype(
        np.float32), np.arange(256, dtype=np.int32) % 4
    wkw = dict(tau=2)
    if framework == "jax":
        def loss(p, b):
            return jcnn.classification_loss(jcnn.mlp_apply(p, b["x"]),
                                            b["y"]), {}
        tr = JTrainer(loss, params, axes, JTrainConfig(
            learning_rate=0.05, wasgd=JWASGDConfig(**wkw)), 2)
        ds = JOrderedDataset({"x": X, "y": y}, 2, 2, 4)
    else:
        def loss(p, b):
            return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}
        tr = Trainer(loss, params_from_numpy(_np(params), device="cpu"),
                     axes, TrainConfig(learning_rate=0.05,
                                       wasgd=WASGDConfig(**wkw)), 2,
                     device="cpu")
        ds = OrderedDataset({"x": X, "y": y}, 2, 2, 4)
    tr.run(ds, 3, metrics_path=path, log_every=1)
    return [json.loads(line) for line in open(path)]


def test_metrics_jsonl_and_log_lines_are_jaxs(tmp_path, capsys):
    ref = _mlp_metrics_run("jax", str(tmp_path / "j.jsonl"))
    log_ref = capsys.readouterr().out
    ours = _mlp_metrics_run("port", str(tmp_path / "t.jsonl"))
    log_ours = capsys.readouterr().out
    assert len(ours) == len(ref) == 3
    assert [line.split()[:2] for line in log_ours.splitlines()] == \
        [line.split()[:2] for line in log_ref.splitlines()] == \
        [["round", f"{r}/3"] for r in (1, 2, 3)]
    for lo, lr in zip(ours, ref):
        assert sorted(lo) == sorted(lr)
        assert lo["round"] == lr["round"]
        for k in ("loss", "loss_last", "h", "theta_entropy", "omega"):
            np.testing.assert_allclose(lo[k], lr[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(lo["theta"], lr["theta"], atol=1e-6)
        np.testing.assert_allclose(lo["scores"], lr["scores"], atol=1e-4)


def test_optimizer_helpers_match_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    jt = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        (ct, nt), (cj, nj) = (clip_by_global_norm(tt, max_norm),
                              jopt.clip_by_global_norm(jt, max_norm))
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        np.testing.assert_allclose(ct["b"]["c"].numpy(),
                                   np.asarray(cj["b"]["c"]), rtol=1e-6)
        np.testing.assert_allclose(ct["a"].numpy(), np.asarray(cj["a"]),
                                   rtol=1e-6)
    for kind, warm in (("constant", 0), ("constant", 10),
                       ("linear_warmup", 10), ("cosine", 0), ("cosine", 10)):
        ours = lr_schedule(kind, 0.1, warm, total_steps=100)
        ref = jopt.lr_schedule(kind, 0.1, warm, total_steps=100)
        for step in (0, 1, 5, 9, 10, 50, 99, 150):
            for s_t in (step, torch.tensor(step)):
                np.testing.assert_allclose(float(ours(s_t)),
                                           float(ref(jnp.int32(step))),
                                           rtol=1e-6,
                                           err_msg=f"{kind} {warm} {step}")
    with pytest.raises(ValueError):
        lr_schedule("nope", 0.1)(0)
