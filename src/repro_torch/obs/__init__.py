"""Telemetry of the port, the counterpart of ``repro/obs``: typed events
(``obs/events.py``) flow into a sink (``obs/sinks.py``): ``NullSink``
(the default: off, the hot path untouched), ``RingSink`` (in memory),
``JsonlSink`` (a writer thread, one JSON line an event). The records are
JAX's, field for field and ``kind`` for ``kind``, so ``repro.obs`` and
``tools/obs_report.py`` read the port's files as they are.

Producers: ``Trainer.run(telemetry=)`` (``RoundTrace``,
``WorkerAssessment``, ``MembershipChange``), ``AsyncCheckpointer``
(``CheckpointSave``), ``ContinuousEngine(telemetry=)`` (``ServeSample``),
``HotSwapBridge`` (``HotSwap``).

Spans (``obs/spans.py``): ``span(name)`` marks the round's phases, the
aggregate's encodes and the MoE layer's parts as profiler ranges while
``recording()`` is on (off by default: a site is then one flag read), for
a profiler run to put the card's kernels and idle gaps down to them.
"""
from repro_torch.obs.events import (CheckpointSave, HotSwap,
                                    MembershipChange, PHASE_NAMES,
                                    RoundTrace, ServeSample,
                                    WorkerAssessment, event_from_record,
                                    summarize_policy_state, to_record)
from repro_torch.obs.sinks import (JsonlSink, NULL, NullSink, RingSink,
                                   Telemetry, read_events)
from repro_torch.obs.spans import SPAN_NAMES, recording, span

__all__ = [
    "CheckpointSave", "HotSwap", "JsonlSink", "MembershipChange", "NULL",
    "NullSink", "PHASE_NAMES", "RingSink", "RoundTrace", "SPAN_NAMES",
    "ServeSample", "Telemetry", "WorkerAssessment", "event_from_record",
    "read_events", "recording", "span", "summarize_policy_state",
    "to_record",
]
