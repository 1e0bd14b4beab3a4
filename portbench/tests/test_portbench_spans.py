"""``yardstick/spans.py`` on hand-made event lists, one CPU round of the
program put down to its spans, and the span metrics' readers found by
name."""
import os
import types

import pytest

from conftest import ROOT, smoke_cell
from portbench import runner, span_report
from portbench.yardstick import spans as sp

US = 1_000


def ev(name, start, end, device=False, thread=1, **kw):
    return sp.Ev(name, start * US, end * US, device, thread, **kw)


def kernel(name, start, end, corr, thread=1):
    return ev(name, start, end, device=True, corr=corr, thread=thread)


def call(start, corr, thread=1):
    return ev("cudaLaunchKernel", start, start + 1, corr=corr,
              thread=thread)


MARKS = [kernel("spin_kernel", 0, 1, 900), call(0, 900),
         kernel("spin_kernel", 99, 100, 901), call(98, 901)]


def attributed(evs, rounds=1):
    return sp.attribute(evs, sp.device_ops(evs), rounds)


def test_a_forward_operation_belongs_to_the_spans_around_its_launch():
    """A kernel launched on thread 1 inside ``moe.dispatch`` belongs to
    it and to the round span around it; one launched on thread 2 at the
    same time belongs to the round span (open on thread 1) alone."""
    evs = MARKS + [
        ev("round.local_steps", 5, 60, user=True),
        ev("moe.dispatch", 10, 20, user=True),
        call(12, 1), kernel("gather", 30, 34, 1),
        call(13, 2, thread=2), kernel("other", 40, 42, 2, thread=2)]
    a = attributed(evs)
    assert a.busy_s("moe.dispatch") == pytest.approx(4e-6)
    assert a.busy_s("round.local_steps") == pytest.approx(6e-6)
    assert a.kernel_s("other") == {"round.local_steps": pytest.approx(2e-6)}
    assert a.early == 0 and a.unlinked == 0


def test_a_backward_operation_belongs_to_its_forward_operations_spans():
    """Inside ``evaluate_function: IndexBackward0`` (forward thread 1,
    sequence 7) on autograd's thread 2, a kernel belongs to the spans
    around thread 1's latest operation of sequence 7 (the ``aten::index``
    in ``moe.combine``; the ``aten::mul`` before it made no node)."""
    back = sp.BACKWARD + " IndexBackward0"
    evs = MARKS + [
        ev("round.local_steps", 2, 90, user=True),
        ev("moe.dispatch", 3, 6, user=True),
        ev("aten::mul", 4, 5, seq=7),
        ev("moe.combine", 8, 12, user=True),
        ev("aten::index", 9, 10, seq=7),
        ev("aten::index", 9, 10, seq=3, thread=2),
        ev(back, 50, 60, thread=2, seq=7, fwd_thread=1),
        call(51, 5, thread=2), kernel("indexing_backward_kernel", 52, 58, 5,
                                      thread=2)]
    a = attributed(evs)
    assert a.kernel_s("indexing_backward") == {
        "moe.combine": pytest.approx(6e-6),
        "round.local_steps": pytest.approx(6e-6)}


def test_the_recompute_belongs_to_its_own_spans():
    """A span entered inside the backward (remat's recompute) is deeper
    than the ``evaluate_function`` around it: a kernel launched in it
    belongs to it."""
    back = sp.BACKWARD + " MmBackward0"
    evs = MARKS + [
        ev("round.local_steps", 2, 90, user=True),
        ev("moe.experts", 3, 6, user=True), ev("aten::mm", 4, 5, seq=1),
        ev(back, 50, 70, thread=2, seq=1, fwd_thread=1),
        ev("moe.dispatch", 52, 56, thread=2, user=True),
        call(53, 5, thread=2), kernel("gather", 54, 55, 5, thread=2),
        call(60, 6, thread=2), kernel("gemm", 61, 63, 6, thread=2)]
    a = attributed(evs)
    assert a.kernel_s("gather") == {"moe.dispatch": pytest.approx(1e-6),
                                    "round.local_steps": pytest.approx(1e-6)}
    assert a.kernel_s("gemm") == {"moe.experts": pytest.approx(2e-6),
                                  "round.local_steps": pytest.approx(2e-6)}


def test_overlapping_streams_count_once_and_annotations_not_at_all():
    evs = MARKS + [
        ev("round.aggregate", 5, 60, user=True),
        ev("agg.encode", 6, 20, user=True),
        call(7, 1), kernel("hash", 10, 20, 1),
        call(8, 2), kernel("copy", 15, 25, 2),
        ev("agg.encode", 10, 30, device=True, user=True, corr=3)]
    a = attributed(evs)
    assert a.busy_s("agg.encode") == pytest.approx(15e-6)
    assert a.busy_s("round.aggregate") == pytest.approx(15e-6)
    assert all("agg.encode" != o[0] for o in a.ops)


def test_idle_gaps_belong_to_the_span_open_at_their_midpoint():
    """The window runs from the first marker's start to the last one's
    end: gaps 0-10 (midpoint in ``round.stage``), 20-50 (midpoint 35, in
    ``round.local_steps``), 60-100 (midpoint 80, in
    ``round.readback``)."""
    evs = MARKS + [
        ev("round.stage", 2, 12, user=True),
        ev("round.local_steps", 12, 70, user=True),
        ev("round.readback", 70, 95, user=True),
        call(13, 1), kernel("a", 10, 20, 1),
        call(40, 2), kernel("b", 50, 60, 2)]
    a = attributed(evs, rounds=2)
    assert a.idle_s("round.stage") == pytest.approx(10e-6)
    assert a.idle_per_round("round.local_steps") == pytest.approx(15e-6)
    assert a.idle_per_round("round.stage", "round.readback") == \
        pytest.approx((10e-6 + 40e-6) / 2)
    assert a.busy_per_round("round.local_steps") == pytest.approx(10e-6)
    assert a.idle_per_round("round.aggregate") is None


def test_coverage_early_and_unlinked_operations():
    """Of 11 us busy, the 6 of the kernel launched inside the round span
    are covered; a kernel with no runtime call is unlinked; one that
    starts before the host start of the round span it was launched in
    is early (the clocks would disagree)."""
    evs = MARKS + [
        ev("round.local_steps", 20, 50, user=True),
        call(10, 1), kernel("outside", 11, 15, 1),
        call(21, 2), kernel("inside", 30, 36, 2),
        kernel("lost", 70, 71, 3)]
    a = attributed(evs)
    cov = a.coverage()
    assert cov["busy"] == pytest.approx(6 / 11)
    assert 0 < cov["idle"] < 1
    assert a.unlinked == 1
    early = attributed(evs + [call(40, 4), kernel("early", 18, 19, 4)])
    assert early.early == 1


def test_a_cpu_round_of_the_program_is_put_down_to_its_spans(cpu):
    """One WASGD+ round of the smoke MoE cell (int4 payload, remat) on
    the CPU with the spans recording: its aten operators as the work.
    Every reader gives a value; the MoE layer's lies within the local
    steps', the encode's within the aggregate's; most of the work lies
    in a round span."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers import train as drv
    from portbench.yardstick.tokens import lm_data
    from repro_torch.obs import recording
    cell = smoke_cell("moe", "wasgd_p4_tau4_seq640_f32", "olmoe_train",
                      backend="pallas_wagg:int4")
    t = cell.traffic
    data = lm_data(5, t["data"], t["seq_len"],
                   cell.config["model"]["vocab_size"])
    prog = drv.Program(cell, 5, cpu, data)
    prog.round()
    with recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.round()
    evs = sp.events(prof)
    a = sp.attribute(evs, sp.host_ops(evs), 1)
    got = span_report.read_metrics(a)
    assert all(v is not None and v >= 0 for v in got.values()), got
    moe = sum(got[f"moe_{k}_busy_s.train"]
              for k in ("dispatch", "experts", "combine"))
    assert 0 < moe <= got["local_steps_busy_s.train"]
    assert 0 < got["int4_encode_busy_s.train"] <= \
        got["aggregate_busy_s.train"]
    assert a.coverage()["busy"] > 0.95 and a.early == 0


@pytest.mark.parametrize("name", span_report.SPAN_METRICS)
def test_every_span_metric_is_found_by_name(name):
    read = runner.reader(name)
    assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                       name + ".py"))
    assert read(types.SimpleNamespace()) is None
    evs = MARKS + [ev("other", 5, 10, user=True), call(6, 1),
                   kernel("k", 7, 8, 1)]
    assert read(types.SimpleNamespace(spans=attributed(evs))) is None
