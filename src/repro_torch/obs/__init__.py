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
"""
from repro_torch.obs.events import (CheckpointSave, HotSwap,
                                    MembershipChange, PHASE_NAMES,
                                    RoundTrace, ServeSample,
                                    WorkerAssessment, event_from_record,
                                    summarize_policy_state, to_record)
from repro_torch.obs.sinks import (JsonlSink, NULL, NullSink, RingSink,
                                   Telemetry, read_events)

__all__ = [
    "CheckpointSave", "HotSwap", "JsonlSink", "MembershipChange", "NULL",
    "NullSink", "PHASE_NAMES", "RingSink", "RoundTrace", "ServeSample",
    "Telemetry", "WorkerAssessment", "event_from_record", "read_events",
    "summarize_policy_state", "to_record",
]
