"""Reading the card's activity out of a ``torch.profiler`` run.

A traced window is bracketed by two marker kernels (``torch.cuda._sleep``
after a synchronize, seen in the trace as ``spin_kernel``), so the window
is measured on the card's own clock. Device time is the union of the
device operations' intervals inside it (a kernel on a side stream that
overlaps another counts once), and the idle share is what the union
leaves of the window."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"
Event = Tuple[str, int, int]            # name, start ns, end ns


def mark() -> None:
    """A marker kernel behind everything queued so far."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(cpu: bool = False):
    """A profiler over the card (and the host's operations with
    ``cpu``), the block between two markers. The profiler keeps the
    device records that fall inside its own window, so it idles a
    quarter of a second on either side of the markers."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        time.sleep(0.25)
        mark()
        yield prof
        mark()
        time.sleep(0.25)


def _get(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f() if callable(f) else f
    return None


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a profiler run, in ns on one
    clock."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _get(e, "start_ns")
        if start is None:
            start = int(_get(e, "start_us") * 1000)
        dur = _get(e, "duration_ns")
        if dur is None:
            dur = int(_get(e, "duration_us") * 1000)
        ev = (_get(e, "name"), int(start), int(start) + int(dur))
        if _get(e, "device_type") == torch.autograd.DeviceType.CUDA:
            dev.append(ev)
        else:
            host.append(ev)
    return dev, host


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


class Window:
    """The device events between a traced block's markers."""

    def __init__(self, dev: List[Event], host: Optional[List[Event]] = None):
        marks = sorted(e for e in dev if MARKER in e[0])
        if len(marks) >= 2:
            self.t0, self.t1 = marks[0][1], marks[-1][2]
        else:
            self.t0 = min(e[1] for e in dev)
            self.t1 = max(e[2] for e in dev)
        self.ops = [e for e in dev if MARKER not in e[0]
                    and e[1] >= self.t0 and e[2] <= self.t1]
        self.host = host or []
        self.busy = _union([(a, b) for _, a, b in self.ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernels(self) -> List[Event]:
        return [e for e in self.ops if is_kernel(e[0])]

    def kernel_time(self, name: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``name``."""
        hits = [e for e in self.ops if name in e[0]]
        return len(hits), sum(b - a for _, a, b in hits) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[int, int]]:
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps, each named by the innermost host
        operation running at its middle (``host`` events needed; else
        ``"idle"``)."""
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) // 2
            inside = [e for e in self.host if e[1] <= mid <= e[2]]
            name = min(inside, key=lambda e: e[2] - e[1])[0] if inside \
                else "idle"
            out.append([name[:120], (b - a) / 1e9])
        return out
