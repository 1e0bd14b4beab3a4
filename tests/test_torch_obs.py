"""The port's telemetry (``repro_torch/obs``, the producers in
``Trainer.run``, ``AsyncCheckpointer``, ``ContinuousEngine`` and
``HotSwapBridge``), case for case against ``tests/test_obs.py``.

Three guarantees, as in the JAX package:

* **NullSink no-op**: the default path is the uninstrumented one: params
  bitwise, no fence (counted), no phased step built;
* **event fidelity**: every run mode (sync, Alg. 4, pipelined, elastic
  with checkpoints, serving, hot swap) emits its typed events, the JSONL
  round trip keeps them, and the phase-fenced round gives the fused
  round's params bitwise;
* **the JAX package reads the port's files**: ``repro.obs`` rebuilds every
  record of a port run, and ``tools/obs_report.py`` renders it unchanged.

Where a JAX run is the comparison (the MLP of ``tests/test_obs.py``, the
gemma3 smoke engine), both start from JAX's params carried over through
numpy; worker assessments are held to JAX's within
``tests/test_torch_train.py``'s tolerances (theta atol 1e-6, energies
rtol 1e-5) and greedy tokens exactly.
"""
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import repro.obs as jobs  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import WASGDConfig as JWASGDConfig  # noqa: E402
from repro.data import OrderedDataset as JOrderedDataset  # noqa: E402
from repro.data import make_classification as j_make_classification  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.param import build as j_build  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import TrainConfig, WASGDConfig  # noqa: E402
from repro_torch.core import MembershipSchedule  # noqa: E402
from repro_torch.data import OrderedDataset, RoundPrefetcher  # noqa: E402
from repro_torch.models import (classification_loss, mlp_apply,  # noqa: E402
                                params_from_numpy)
from repro_torch.obs import (NULL, PHASE_NAMES, CheckpointSave,  # noqa: E402
                             HotSwap, JsonlSink, MembershipChange, NullSink,
                             RingSink, RoundTrace, ServeSample, Telemetry,
                             WorkerAssessment, event_from_record,
                             read_events, summarize_policy_state, to_record)
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _problem(seed=0):
    X, y = j_make_classification(seed, 1024, d=16, n_classes=4)
    pj, axes = j_build(functools.partial(
        jcnn.mlp_init, d_in=16, d_hidden=32, n_classes=4),
        jax.random.key(seed))

    def loss_fn(p, b):
        return classification_loss(mlp_apply(p, b["x"]), b["y"]), {}

    def jloss(p, b):
        return jcnn.classification_loss(jcnn.mlp_apply(p, b["x"]),
                                        b["y"]), {}

    params = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return X, y, params, axes, loss_fn, pj, jloss


def _ds(X, y, w=2, tau=2, bl=8, cls=OrderedDataset, **kw):
    return cls({"x": X, "y": y}, w, tau, bl, n_segments=1, **kw)


def _trees_equal(a, b):
    return all(torch.equal(x, z)
               for x, z in zip(tree_leaves(a), tree_leaves(b)))


def _trainer(p=2, pipeline=None, rule="wasgd", **wkw):
    X, y, params, axes, loss_fn, *_ = _problem()
    tcfg = TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(tau=2, **wkw))
    return X, y, Trainer(loss_fn, params, axes, tcfg, p, rule=rule,
                         device="cpu", pipeline=pipeline)


# ---------------------------------------------------------------------------
# Events + sinks
# ---------------------------------------------------------------------------

EVENTS = [
    RoundTrace(round=3, total_s=0.5, host_staging_s=0.01,
               phases={"local_steps": 0.3, "reduce": 0.1},
               detail="phased", p=4),
    WorkerAssessment(round=3, theta=[0.25, 0.75], energies=[1.0, 0.5],
                     theta_entropy=0.56, active=[True, False],
                     policy="boltzmann",
                     policy_state={"n_leaves": 2, "l2": 1.5}),
    ServeSample(chunk_s=0.1, steps=8, tokens=16, itl_s=0.0125,
                n_running=2, queue_depth=1, admitted=2, finished=1,
                blocks_free=10, blocks_total=16, occupancy=0.375,
                ttft_s=[0.2], e2e_s=[1.1]),
    MembershipChange(round=2, old_p=2, new_p=3, generation=1),
    CheckpointSave(path="/tmp/ck", round=2, duration_s=0.05, nbytes=1024),
    HotSwap(round=4, rounds_since_last=2, tokens_under_prev=64,
            param_drift_l2=0.7, in_flight=3),
]


@pytest.mark.parametrize("event", EVENTS, ids=lambda e: e.kind)
def test_event_record_round_trip_and_jax_schema(event):
    """Each record round-trips through JSON into the port's type and into
    JAX's, whose ``to_record`` gives back the same record."""
    rec = to_record(event)
    assert rec["kind"] == event.kind
    back = event_from_record(json.loads(json.dumps(rec)))
    assert type(back) is type(event)
    for k, v in rec.items():
        if k != "kind":
            assert getattr(back, k) == (pytest.approx(v)
                                        if isinstance(v, float) else v)
    assert jobs.to_record(jobs.event_from_record(rec)) == rec


def test_event_from_record_rejects_unknown_kind_drops_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        event_from_record({"kind": "nope"})
    e = event_from_record({"kind": "membership_change", "round": 1,
                           "old_p": 2, "new_p": 4, "from_the_future": 9})
    assert (e.old_p, e.new_p) == (2, 4)
    assert not hasattr(e, "from_the_future")
    assert PHASE_NAMES == jobs.PHASE_NAMES


def test_tensors_become_lists_and_policy_state_summary_is_jaxs():
    rec = to_record(WorkerAssessment(
        round=0, theta=torch.tensor([0.5, 0.5]), energies=[1.0, 2.0],
        theta_entropy=0.69))
    assert rec["theta"] == [0.5, 0.5]
    state = {"m": np.array([3.0, 4.0], np.float32), "t": np.array(2.0)}
    ours = summarize_policy_state({k: torch.from_numpy(np.asarray(v))
                                   for k, v in state.items()})
    assert ours == jobs.summarize_policy_state(state)
    assert summarize_policy_state(()) is None


def test_sinks_satisfy_protocol_and_ring_caps():
    assert isinstance(NULL, Telemetry)
    assert isinstance(NullSink(), Telemetry)
    ring = RingSink(maxlen=3)
    assert isinstance(ring, Telemetry)
    for r in range(5):
        ring.emit(MembershipChange(round=r, old_p=2, new_p=2))
    assert [e.round for e in ring.events()] == [2, 3, 4]
    assert not NULL.enabled and ring.enabled


def test_jsonl_sink_round_trip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sink = JsonlSink(path)
    sink.emit(RoundTrace(round=0, total_s=1.0, phases={"reduce": 0.5}))
    sink.emit(WorkerAssessment(round=0, theta=[1.0], energies=[2.0],
                               theta_entropy=0.0))
    sink.close()
    assert sink.n_emitted == 2
    evs = list(read_events(path))
    assert [e.kind for e in evs] == ["round_trace", "worker_assessment"]
    assert evs[0].phases == {"reduce": 0.5}
    assert evs[1].theta == [1.0]


def test_jsonl_sink_surfaces_writer_failure(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sink = JsonlSink(path)
    sink._f.close()
    sink.emit(MembershipChange(round=0, old_p=1, new_p=2))
    with pytest.raises(RuntimeError, match="telemetry writer failed"):
        sink.close()


# ---------------------------------------------------------------------------
# NullSink no-op guarantee
# ---------------------------------------------------------------------------

def _count_fences(monkeypatch):
    import repro_torch.serve.engine as engine_mod
    import repro_torch.train.step as step_mod
    import repro_torch.train.trainer as trainer_mod
    calls = []
    for mod, tag in ((trainer_mod, "t"), (engine_mod, "e"), (step_mod, "p")):
        monkeypatch.setattr(mod, "fence",
                            lambda dev, tag=tag: calls.append(tag))
    return calls


def test_null_sink_path_is_bitwise_noop_and_fence_free(monkeypatch):
    """telemetry=None and telemetry=NullSink() run the fused step: no
    fence, no phased step, the same params; a real sink fences."""
    calls = _count_fences(monkeypatch)
    X, y, tr0 = _trainer()
    tr0.run(_ds(X, y).batches(), 4)
    _, _, tr1 = _trainer()
    tr1.run(_ds(X, y).batches(), 4, telemetry=NullSink())
    assert calls == []
    assert tr1._phased_cache == {}
    assert _trees_equal(tr0.state.params, tr1.state.params)
    _, _, tr2 = _trainer(rule="seq")
    tr2.run(_ds(X, y).batches(), 2, telemetry=RingSink())
    assert calls == ["t", "t"]                   # one fence a fused round


@pytest.mark.parametrize("wkw", [
    {}, {"backend": "pallas_wagg:f32"},
    {"backend": "hierarchical:int8", "n_pods": 2},
    {"backend": "einsum:int4"},
    {"async_mode": "on_device", "policy": "ema(0.9)"}],
    ids=["default", "pallas_wagg", "hierarchical", "int4", "async_ema"])
def test_phased_instrumented_round_matches_fused_params(wkw):
    """With a real sink the round runs phase by phase; params and the
    round's metrics are bitwise the fused round's."""
    X, y, tr0 = _trainer(p=4, **wkw)
    tr0.run(_ds(X, y, w=4).batches(), 3)
    sink = RingSink()
    _, _, tr1 = _trainer(p=4, **wkw)
    tr1.run(_ds(X, y, w=4).batches(), 3, telemetry=sink)
    assert _trees_equal(tr0.state.params, tr1.state.params)
    for a, b in zip(tr0.history, tr1.history):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    traces = sink.by_kind("round_trace")
    assert len(traces) == 3 and all(t.detail == "phased" for t in traces)
    two = wkw.get("backend", "").startswith("hierarchical")
    want = ({"local_steps", "judge", "reduce_scatter", "all_gather",
             "finalize"} if two else
            {"local_steps", "judge", "reduce", "finalize"})
    assert all(set(t.phases) == want for t in traces)


def test_phased_round_times_the_overlap_thunk():
    X, y, params, axes, loss_fn, *_ = _problem()
    seen = []
    tcfg = TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(
        tau=2, backend="hierarchical:f32", n_pods=2))
    runs = []
    for sink in (None, RingSink()):
        tr = Trainer(loss_fn, params, axes, tcfg, 2, device="cpu",
                     overlap=lambda: seen.append(1) or torch.ones(3))
        tr.run(_ds(X, y).batches(), 2, telemetry=sink)
        runs.append(tr)
    assert len(seen) == 4
    assert _trees_equal(runs[0].state.params, runs[1].state.params)
    np.testing.assert_array_equal(runs[1].history[0]["overlap"], np.ones(3))
    phases = sink.by_kind("round_trace")[0].phases
    assert list(phases) == ["local_steps", "judge", "reduce_scatter",
                            "overlap", "all_gather", "finalize"]


# ---------------------------------------------------------------------------
# Per-mode event emission
# ---------------------------------------------------------------------------

def test_sync_run_emits_phased_round_trace_and_assessment_like_jax():
    X, y, params, axes, loss_fn, pj, jloss = _problem()
    sink, jsink = RingSink(), jobs.RingSink()
    tr = Trainer(loss_fn, params, axes,
                 TrainConfig(learning_rate=0.05, wasgd=WASGDConfig(tau=2)),
                 2, device="cpu")
    tr.run(_ds(X, y).batches(), 3, telemetry=sink)
    jtr = JTrainer(jloss, pj, axes,
                   JTrainConfig(learning_rate=0.05,
                                wasgd=JWASGDConfig(tau=2)), 2)
    jtr.run(_ds(X, y, cls=JOrderedDataset).batches(), 3, telemetry=jsink)

    assert [e.kind for e in sink.events()] == \
        [e.kind for e in jsink.events()]
    traces = sink.by_kind("round_trace")
    assert len(traces) == 3
    for t, jt in zip(traces, jsink.by_kind("round_trace")):
        assert t.detail == jt.detail == "phased" and t.p == jt.p == 2
        assert set(t.phases) == set(jt.phases) == {"local_steps", "judge",
                                                   "reduce", "finalize"}
        assert all(v >= 0 for v in t.phases.values())
        assert t.total_s >= max(t.phases.values())
        assert t.host_staging_s >= 0
    for a, ja in zip(sink.by_kind("worker_assessment"),
                     jsink.by_kind("worker_assessment")):
        np.testing.assert_allclose(a.theta, ja.theta, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.energies, ja.energies, rtol=1e-5)
        assert a.theta_entropy == pytest.approx(ja.theta_entropy, abs=1e-5)
        assert sum(a.theta) == pytest.approx(1.0, abs=1e-5)
        assert a.policy == ja.policy == "boltzmann"
        assert a.active is None and ja.active is None
        assert a.policy_state == ja.policy_state is None


def test_async_on_device_run_emits_active_mask():
    sink = RingSink()
    X, y, tr = _trainer(p=3, async_mode="on_device", policy="ema(0.9)")
    sched = np.array([[True, True, True], [True, False, True],
                      [False, True, True]])
    tr.run(_ds(X, y, w=3).batches(), 3, telemetry=sink,
           straggler_schedule=sched)
    wa = sink.by_kind("worker_assessment")
    assert [a.active for a in wa] == sched.tolist()
    assert all(isinstance(f, bool) for a in wa for f in a.active)
    assert all(a.policy_state["n_leaves"] >= 1 for a in wa)
    assert [a.theta[i] for a, i in zip(wa[1:], (1, 0))] == [0.0, 0.0]
    assert all(t.detail == "phased" for t in sink.by_kind("round_trace"))


@pytest.mark.parametrize("pipeline", ["parity", "speculative"])
def test_pipelined_run_emits_coarse_round_trace(pipeline):
    sink = RingSink()
    X, y, tr = _trainer(pipeline=pipeline)
    tr.run(_ds(X, y, boundary_delay=RoundPrefetcher.run_ahead()), 3,
           telemetry=sink)
    traces = sink.by_kind("round_trace")
    assert len(traces) == 3
    assert all(t.detail == "fused" and t.phases == {} for t in traces)
    assert len(sink.by_kind("worker_assessment")) == 3


def test_elastic_run_emits_membership_and_checkpoint_events(tmp_path):
    sink = RingSink()
    X, y, tr = _trainer()
    tr.run(_ds(X, y), 4, telemetry=sink,
           membership_schedule=MembershipSchedule(2, {2: 3}),
           checkpoint_every=2, checkpoint_path=str(tmp_path / "ck"))
    mc = sink.by_kind("membership_change")
    assert [(e.round, e.old_p, e.new_p, e.generation) for e in mc] == \
        [(2, 2, 3, 1)]
    cs = sink.by_kind("checkpoint_save")
    assert sorted(e.round for e in cs) == [2, 4]
    for e in cs:
        assert e.duration_s > 0 and e.nbytes > 0
        assert os.path.isdir(e.path)
    wa = sink.by_kind("worker_assessment")
    assert [len(a.theta) for a in wa] == [2, 2, 3, 3]


def test_checkpointer_bytes_are_the_files_payload(tmp_path):
    from repro_torch.checkpoint import AsyncCheckpointer, restore
    sink = RingSink()
    ck = AsyncCheckpointer(telemetry=sink)
    tree = {"a": torch.ones(3, 4), "b": {"c": torch.zeros(5,
                                                          dtype=torch.bfloat16)}}
    ck.save(str(tmp_path / "x"), tree, meta={"round": 7})
    ck.close()
    (e,) = sink.by_kind("checkpoint_save")
    assert (e.round, e.nbytes) == (7, 3 * 4 * 4 + 5 * 2)
    back, _ = restore(str(tmp_path / "x"), tree)
    assert _trees_equal(back, tree)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _serve_setup(telemetry=None, jax_engine=False, jax_telemetry=None):
    from repro.configs import get_smoke_config as j_smoke
    from repro.data import lm_batch
    from repro.models import init_params as j_init_params
    from repro.serve import ContinuousEngine as JEngine
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import ContinuousEngine
    jcfg = dataclasses.replace(j_smoke("gemma3-1b"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"),
                              compute_dtype="float32")
    jp, _ = j_init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(n_slots=2, max_len=64, block_size=8, chunk=8)
    eng = ContinuousEngine(cfg, params, cache_dtype=torch.float32,
                           device="cpu", telemetry=telemetry, **kw)
    jeng = (JEngine(jcfg, jp, cache_dtype=jnp.float32,
                    telemetry=jax_telemetry, **kw) if jax_engine else None)
    prompts = np.asarray(lm_batch(0, 3, 8, cfg.vocab_size)["tokens"])
    return params, eng, jeng, prompts


def test_continuous_engine_emits_serve_samples_and_stays_bitwise(
        monkeypatch):
    calls = _count_fences(monkeypatch)
    sink, jsink = RingSink(), jobs.RingSink()
    _, eng, jeng, prompts = _serve_setup(sink, jax_engine=True,
                                         jax_telemetry=jsink)
    out = eng.generate(prompts, n_new=12)
    samples = sink.by_kind("serve_sample")
    assert samples and len(calls) == len(samples) + eng.prefills
    assert sum(s.tokens for s in samples) == eng.tokens_generated == 36
    ttft = [t for s in samples for t in s.ttft_s]
    assert len(ttft) == 3 and all(t > 0 for t in ttft)
    e2e = [t for s in samples for t in s.e2e_s]
    assert len(e2e) == 3 and all(t > 0 for t in e2e)
    for s in samples:
        assert s.steps >= 1 and s.itl_s == pytest.approx(s.chunk_s / s.steps)
        assert 0.0 <= s.occupancy <= 1.0
        assert s.blocks_free + round(s.occupancy * s.blocks_total) \
            == s.blocks_total
    # JAX's engine on the same weights: the same tokens, the same totals
    np.testing.assert_array_equal(out, jeng.generate(prompts, n_new=12))
    jsamples = jsink.by_kind("serve_sample")
    assert sum(s.tokens for s in jsamples) == 36
    assert samples[-1].blocks_total == jsamples[-1].blocks_total
    # telemetry must not perturb decoding, and NullSink adds no fence
    calls.clear()
    _, eng2, _, _ = _serve_setup(NullSink())
    np.testing.assert_array_equal(out, eng2.generate(prompts, n_new=12))
    assert calls == []


def test_hot_swap_bridge_emits_hot_swap_event():
    from repro_torch.serve import HotSwapBridge
    sink = RingSink()
    params, eng, _, prompts = _serve_setup(telemetry=sink)
    bridge = HotSwapBridge(eng)              # inherits the engine's sink
    assert HotSwapBridge(eng, telemetry=NULL).telemetry is NULL
    eng.generate(prompts, n_new=4)
    bridge(5, *_stacked(params))
    bridge(9, *_stacked(params))
    hs = sink.by_kind("hot_swap")
    assert [(e.round, e.rounds_since_last) for e in hs] == [(5, None),
                                                           (9, 4)]
    assert hs[0].tokens_under_prev == eng.tokens_generated
    assert hs[1].tokens_under_prev == 0
    assert hs[1].param_drift_l2 == 0.0
    assert [to_record(e) for e in hs] == \
        [{"kind": "hot_swap", **r, "t_wall": e.t_wall}
         for r, e in zip(bridge.swaps, hs)]


def _stacked(params):
    """Two equal worker copies of ``params`` and their axes."""
    flat = {k: torch.stack([v, v]) for k, v in _flat(params).items()}
    axes = {k: ("worker",) + (None,) * (v.dim() - 1) for k, v in flat.items()}
    return _unflat(flat), _unflat(axes)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


# ---------------------------------------------------------------------------
# The JAX package reads the port's files
# ---------------------------------------------------------------------------

def _port_run_to_jsonl(path, tmp_path):
    sink = JsonlSink(path)
    X, y, tr = _trainer()
    tr.run(_ds(X, y), 4, telemetry=sink,
           membership_schedule=MembershipSchedule(2, {2: 3}),
           checkpoint_every=2, checkpoint_path=str(tmp_path / "ck"))
    params, eng, _, prompts = _serve_setup(telemetry=sink)
    from repro_torch.serve import HotSwapBridge
    eng.generate(prompts, n_new=6)
    HotSwapBridge(eng)(3, *_stacked(params))
    sink.close()


def test_jax_package_rebuilds_every_record_of_a_port_run(tmp_path):
    path = str(tmp_path / "port.jsonl")
    _port_run_to_jsonl(path, tmp_path)
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    kinds = {r["kind"] for r in recs}
    assert kinds == {"round_trace", "worker_assessment", "membership_change",
                     "checkpoint_save", "serve_sample", "hot_swap"}
    for rec in recs:
        ev = jobs.event_from_record(rec)
        assert jobs.to_record(ev) == rec
    ours = list(read_events(path))
    assert [to_record(e) for e in ours] == recs


def test_obs_report_renders_a_port_run(tmp_path, capsys):
    from tools.obs_report import main
    path = str(tmp_path / "port.jsonl")
    _port_run_to_jsonl(path, tmp_path)
    assert main([path]) == 0
    out = capsys.readouterr().out
    for needle in ("rounds: 4", "local_steps", "judge", "reduce",
                   "finalize", "theta entropy", "policy=boltzmann"):
        assert needle in out, needle
    assert main([path, "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["rounds"]["n"] == 4 and s["rounds"]["detail"] == ["phased"]
    assert s["membership"] == [{"round": 2, "old_p": 2, "new_p": 3}]
    assert s["hot_swaps"]["n"] == 1
    assert s["serve"]["tokens"] == 18
    assert s["checkpoints"]["total_bytes"] > 0


def test_port_reads_a_jax_run(tmp_path):
    X, y, params, axes, loss_fn, pj, jloss = _problem()
    path = str(tmp_path / "jax.jsonl")
    sink = jobs.JsonlSink(path)
    jtr = JTrainer(jloss, pj, axes,
                   JTrainConfig(learning_rate=0.05,
                                wasgd=JWASGDConfig(tau=2)), 2)
    jtr.run(_ds(X, y, cls=JOrderedDataset).batches(), 2, telemetry=sink)
    sink.close()
    evs = list(read_events(path))
    assert [e.kind for e in evs] == ["round_trace", "worker_assessment"] * 2
    assert isinstance(evs[0], RoundTrace) and evs[0].detail == "phased"
