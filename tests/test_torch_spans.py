"""The port's record-only spans (``repro_torch/obs/spans.py``) in a fused
WASGD+ round of the smoke MoE LM (remat on, ``pallas_wagg:int4``, whose
CPU path is the kernel's plain version):

* **off by default, and then untouched**: the round enters no
  ``record_function``;
* **record-only**: with the switch on, the round's params and metrics
  are bitwise those with it off;
* **every span in the trace**: a CPU profile of the round holds every
  name of ``SPAN_NAMES``, the MoE spans also inside the backward (remat's
  recompute);
* **the backward links to its forward**: each ``IndexBackward0``'s
  (forward thread, sequence number) names an ``aten::index``, those of
  the MoE layer inside ``moe.dispatch`` or ``moe.combine``.
"""
import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (TrainConfig, WASGDConfig,  # noqa: E402
                                 get_smoke_config)
from repro_torch.data import OrderedDataset, make_tokens  # noqa: E402
from repro_torch.models import init_params, param_axes  # noqa: E402
from repro_torch.obs import SPAN_NAMES, recording, span  # noqa: E402
from repro_torch.obs import spans as obs_spans  # noqa: E402
from repro_torch.train import Trainer, make_lm_loss  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

P, TAU, B_LOCAL, SEQ = 2, 2, 1, 16
BACKWARD = "autograd::engine::evaluate_function: "


def _trainer():
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), remat=True,
                              compute_dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    toks = make_tokens(0, 64, SEQ, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tcfg = TrainConfig(learning_rate=0.03, optimizer="sgd",
                       wasgd=WASGDConfig(tau=TAU, beta=0.9,
                                         strategy="boltzmann",
                                         backend="pallas_wagg:int4"))
    tr = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg, P,
                 rule="wasgd+", device="cpu")
    return tr, OrderedDataset(data, P, TAU, B_LOCAL, n_segments=1)


def _round(recorded=False):
    tr, ds = _trainer()
    with recording(recorded):
        tr.run(ds, 1)
    return tr


def _profiled_round():
    from torch.profiler import ProfilerActivity, profile
    tr, ds = _trainer()
    with recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(ds, 1)
    return list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module")
def round_events():
    return _profiled_round()


def test_spans_are_off_by_default_and_enter_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("round.stage") is span("moe.route")
    _round()


@pytest.mark.parametrize("on", [False, True])
def test_recording_restores_the_previous_setting(on):
    with recording(on):
        assert (span("round.stage") is span("moe.route")) is not on
        with recording(not on):
            assert (span("round.stage") is span("moe.route")) is on
        assert (span("round.stage") is span("moe.route")) is not on
    assert span("round.stage") is span("moe.route")


def test_the_switch_holds_on_every_thread():
    seen = []
    with recording():
        t = threading.Thread(target=lambda: seen.append(
            span("moe.route") is not span("moe.dispatch")))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [True]


def test_recording_leaves_params_and_metrics_bitwise():
    off, on = _round(False), _round(True)
    for a, b in zip(tree_leaves(off.state.params),
                    tree_leaves(on.state.params)):
        assert torch.equal(a, b)
    assert off.history[0].keys() == on.history[0].keys()
    for k, v in off.history[0].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(on.history[0][k]))


@pytest.mark.parametrize("name", SPAN_NAMES)
def test_every_span_is_in_the_trace(round_events, name):
    assert any(e.is_user_annotation() and e.name() == name
               for e in round_events)


def _backward_frames(events):
    return [e for e in events if e.name().startswith(BACKWARD)]


def _inside(e, frames):
    return [f for f in frames if f.start_thread_id() == e.start_thread_id()
            and f.start_ns() <= e.start_ns()
            and e.start_ns() + e.duration_ns()
            <= f.start_ns() + f.duration_ns()]


@pytest.mark.parametrize("name", ["moe.route", "moe.dispatch", "moe.experts",
                                  "moe.combine"])
def test_moe_spans_run_again_in_the_backward(round_events, name):
    """remat's recompute enters the MoE spans inside an autograd
    ``evaluate_function``: 2 layers x tau local steps, forward and
    recompute."""
    back = _backward_frames(round_events)
    mine = [e for e in round_events if e.is_user_annotation()
            and e.name() == name]
    again = [e for e in mine if _inside(e, back)]
    assert len(mine) == 2 * len(again) == 2 * 2 * TAU


def test_index_backward_links_to_an_index_in_dispatch_or_combine(
        round_events):
    """Each ``IndexBackward0`` (forward thread, sequence number) names an
    ``aten::index`` (the latest host operation with that number on that
    thread); those of the MoE layer lie in its dispatch (2 layers x tau)
    and its combine (as many); the rest, one a step, is the embedding's
    gather."""
    spans = [e for e in round_events if e.is_user_annotation()]
    forward = {}
    for e in sorted(round_events, key=lambda e: e.start_ns()):
        if e.sequence_nr() >= 0 and not e.fwd_thread_id() \
                and not e.name().startswith(BACKWARD):
            forward[(e.start_thread_id(), e.sequence_nr())] = e
    where = []
    for e in _backward_frames(round_events):
        if e.name() == BACKWARD + "IndexBackward0":
            fe = forward[(e.fwd_thread_id(), e.sequence_nr())]
            assert fe.name() == "aten::index"
            moe = {s.name() for s in _inside(fe, spans)} & {
                "moe.dispatch", "moe.combine"}
            where.append(moe.pop() if moe else None)
    assert Counter(where) == {"moe.dispatch": 2 * TAU,
                              "moe.combine": 2 * TAU, None: TAU}


def test_span_names_are_the_module_table():
    doc = obs_spans.__doc__
    assert all(f"    {n} " in doc for n in SPAN_NAMES)
    assert len(set(SPAN_NAMES)) == len(SPAN_NAMES)
