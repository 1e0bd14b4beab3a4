"""Telemetry sinks, a copy of ``repro/obs/sinks.py``.

A sink has three members: ``enabled``, ``emit(event)`` and ``close()``.
Every instrumentation site gates all its telemetry work (fences, host
reads, timestamps) on ``enabled``, so with the default ``NullSink`` the
hot path is the uninstrumented program.

``emit`` is thread-safe: the Trainer's loop, the checkpoint writer and a
serving engine may emit into one sink. ``RingSink`` relies on
``deque.append`` being atomic; ``JsonlSink`` serializes on the caller's
thread and hands the line to a one-thread executor, so writes keep their
order and the emitter never waits on the disk. A failure of the writer
thread is kept under a lock and raised by the next ``emit`` or
``close``.
"""
from __future__ import annotations

import collections
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Protocol, runtime_checkable

from repro_torch.obs.events import event_from_record, to_record


@runtime_checkable
class Telemetry(Protocol):
    """What every sink provides; the Trainer touches only these."""
    enabled: bool

    def emit(self, event) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Telemetry off: ``enabled = False`` short-circuits every site, so
    no fence, no host read and no event is made."""
    enabled = False

    def emit(self, event) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullSink()


class RingSink:
    """The last ``maxlen`` events in memory; ``events()`` copies them,
    ``by_kind`` filters."""
    enabled = True

    def __init__(self, maxlen: int = 4096):
        self._ring: "collections.deque" = collections.deque(maxlen=maxlen)

    def emit(self, event) -> None:
        self._ring.append(event)

    def events(self) -> List:
        return list(self._ring)

    def by_kind(self, kind: str) -> List:
        return [e for e in self._ring if e.kind == kind]

    def close(self) -> None:
        pass


class JsonlSink:
    """One event a line (``to_record``), appended to ``path`` by a writer
    thread. The line is made on the emitting thread (an event may hold
    lists its producer changes later); only the string crosses."""
    enabled = True

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._exc = None
        self._n_emitted = 0
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="obs-jsonl")

    def emit(self, event) -> None:
        line = json.dumps(to_record(event))
        self._raise_pending()
        with self._lock:
            self._n_emitted += 1
        self._pool.submit(self._write, line)

    def _write(self, line: str) -> None:
        try:
            self._f.write(line + "\n")
            self._f.flush()
        except BaseException as e:     # kept; raised on the emitter
            with self._lock:
                self._exc = e

    def _raise_pending(self) -> None:
        with self._lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise RuntimeError(
                f"telemetry writer failed for {self.path}") from exc

    @property
    def n_emitted(self) -> int:
        with self._lock:
            return self._n_emitted

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self._f.close()
        self._raise_pending()


def read_events(path: str) -> Iterator:
    """The typed events of a JSONL file (blank lines skipped)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield event_from_record(json.loads(line))
