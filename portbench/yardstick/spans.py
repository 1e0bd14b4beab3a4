"""Device time of the program's spans, out of a ``torch.profiler`` run
with the host's operations (``trace.profiled(cpu=True)``).

A span is a host user annotation (the program's ``repro_torch.obs.span``,
a ``record_function`` range), on the same clock as the card's kernels.
Each device operation between the window's markers is put down to spans:

* an operation's launch is the runtime call (``cudaLaunchKernel`` and
  the like) of the same correlation id: its thread and its start;
* launched inside a span on that thread (the forward, and remat's
  recompute, which enters the spans again inside the backward), it
  belongs to that span and to every span around it there;
* launched inside an ``autograd::engine::evaluate_function: ...``
  that is deeper than any span around the launch (the backward), it
  belongs to the spans around the forward operation that made the
  autograd node: the host operation on the node's forward thread with
  its sequence number (the latest such, since operations that made no
  node carry the number that the next node takes);
* it also belongs to the ``round.*`` span open, on any thread, at its
  launch: the backward runs on autograd's own thread on a card.

A span's busy time is the union of its operations' intervals (a side
stream's operation that overlaps another counts once); its idle time
is the length of the window's idle gaps whose midpoint falls inside one
of its host intervals on the thread that holds the ``round.*`` spans.
Device annotations (the profiler's ``gpu_user_annotation`` copies of the
spans) are left out: they would cover the idle gaps."""
from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from portbench.yardstick import trace as tr

ROUND = "round."
BACKWARD = "autograd::engine::evaluate_function:"


class Ev(NamedTuple):
    """One profiler event: times in ns on the trace's clock; ``thread``
    the profiler's id of the thread that recorded it (a device event:
    its launcher's); ``corr`` a device event's and its runtime call's
    correlation id; ``seq``/``fwd_thread`` an autograd node's sequence
    number and forward thread (-1 and 0 where there is none)."""
    name: str
    start: int
    end: int
    device: bool
    thread: int = 0
    corr: int = 0
    seq: int = -1
    fwd_thread: int = 0
    user: bool = False


class Op(NamedTuple):
    """A unit of work to put down to spans: its interval, and the thread
    and time of its launch (``thread`` None: no launch found)."""
    name: str
    start: int
    end: int
    thread: Optional[int]
    launch: int


def events(prof) -> List[Ev]:
    """Every event of a profiler run."""
    import torch
    g = tr._get
    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(g(e, "start_ns"))
        out.append(Ev(
            name=g(e, "name"), start=start,
            end=start + int(g(e, "duration_ns")),
            device=g(e, "device_type") == torch.autograd.DeviceType.CUDA,
            thread=int(g(e, "start_thread_id") or 0),
            corr=int(g(e, "correlation_id") or 0),
            seq=int(g(e, "sequence_nr")),
            fwd_thread=int(g(e, "fwd_thread_id") or 0),
            user=bool(g(e, "is_user_annotation"))))
    return out


def is_runtime(name: str) -> bool:
    """A call of the CUDA API that the profiler records on the host
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
    ...)."""
    return name.startswith("cu") and not name.startswith("cublas")


def device_ops(evs: Sequence[Ev]) -> List[Op]:
    """The device operations (annotations left out, the markers kept),
    each with its launching runtime call's thread and start."""
    launch = {e.corr: e for e in evs
              if not e.device and e.corr and is_runtime(e.name)}
    out = []
    for e in evs:
        if not e.device or e.user:
            continue
        call = launch.get(e.corr)
        out.append(Op(e.name, e.start, e.end,
                      call.thread if call else None,
                      call.start if call else e.start))
    return out


def host_ops(evs: Sequence[Ev]) -> List[Op]:
    """The host's ``aten::`` operators as their own launches: the work
    of a run on the CPU."""
    return [Op(e.name, e.start, e.end, e.thread, e.start) for e in evs
            if not e.device and e.name.startswith("aten::")]


class _Frame(NamedTuple):
    start: int
    end: int
    name: str
    backward: bool
    key: Tuple[int, int]            # a backward's (forward thread, seq)


def _stacks(frames: List[_Frame], times: List[Tuple[int, int]]
            ) -> Dict[int, Tuple[_Frame, ...]]:
    """The frames open at each query (t, id), outermost first; the
    frames of one thread nest."""
    frames = sorted(frames, key=lambda f: (f.start, -f.end))
    out, stack, i = {}, [], 0
    for t, qid in sorted(times):
        while i < len(frames) and frames[i].start <= t:
            f = frames[i]
            while stack and stack[-1].end < f.start:
                stack.pop()
            stack.append(f)
            i += 1
        out[qid] = tuple(f for f in stack if f.end >= t)
    return out


def _spans_of(stack: Tuple[_Frame, ...]) -> Tuple[Tuple[_Frame, ...],
                                                  Optional[_Frame]]:
    """The span frames of a stack, and the backward deeper than every
    one of them, if any."""
    spans = tuple(f for f in stack if not f.backward)
    back = [f for f in stack if f.backward]
    deep = back[-1] if back and (not spans
                                 or back[-1].start >= spans[-1].start) \
        else None
    return spans, deep


@dataclasses.dataclass
class Attribution:
    """The spans' device time over ``rounds`` rounds."""
    rounds: int
    ops: List[Tuple[str, int, int, frozenset]]  # name, start, end, spans
    gaps: List[Tuple[int, int, frozenset]]     # idle gap, spans open
    seen: frozenset                            # span names in the trace
    window_s: float
    early: int              # operations that start before their span
    unlinked: int           # device operations with no launch found

    def busy_s(self, *names: str) -> float:
        """Seconds of the union of the operations of any of ``names``."""
        want = set(names)
        return sum(b - a for a, b in tr._union(
            [(a, b) for _, a, b, s in self.ops if s & want])) / 1e9

    def idle_s(self, *names: str) -> float:
        """Seconds of the idle gaps inside any of ``names``."""
        want = set(names)
        return sum(b - a for a, b, s in self.gaps if s & want) / 1e9

    def busy_per_round(self, *names: str) -> Optional[float]:
        """``busy_s`` a round; None when none of ``names`` was recorded."""
        return self.busy_s(*names) / self.rounds \
            if self.seen & set(names) else None

    def idle_per_round(self, *names: str) -> Optional[float]:
        """``idle_s`` a round; None when none of ``names`` was recorded."""
        return self.idle_s(*names) / self.rounds \
            if self.seen & set(names) else None

    def coverage(self) -> Dict[str, float]:
        """The share of the window's busy and of its idle time put down
        to a ``round.*`` span."""
        rounds = {n for n in self.seen if n.startswith(ROUND)}
        all_busy = sum(b - a for a, b in tr._union(
            [(a, b) for _, a, b, _ in self.ops])) / 1e9
        all_idle = sum(b - a for a, b, _ in self.gaps) / 1e9
        return {"busy": self.busy_s(*rounds) / all_busy if all_busy else 0.0,
                "idle": self.idle_s(*rounds) / all_idle if all_idle else 0.0}

    def kernel_s(self, part: str) -> Dict[str, float]:
        """Seconds of the operations whose name holds ``part``, by span
        (``""``: in none)."""
        out: Dict[str, float] = defaultdict(float)
        for name, a, b, s in self.ops:
            if part in name:
                for n in s or {""}:
                    out[n] += (b - a) / 1e9
        return dict(out)


def attribute(evs: Sequence[Ev], ops: Sequence[Op],
              rounds: int) -> Attribution:
    """The spans of ``evs`` with the device time of ``ops`` (those
    between the window's markers) and the window's idle gaps."""
    host = [e for e in evs if not e.device]
    frames: Dict[int, List[_Frame]] = defaultdict(list)
    forward: Dict[Tuple[int, int], Ev] = {}
    for e in sorted(host, key=lambda e: e.start):
        if e.user:
            frames[e.thread].append(_Frame(e.start, e.end, e.name, False,
                                           (0, -1)))
        elif e.name.startswith(BACKWARD):
            frames[e.thread].append(_Frame(e.start, e.end, e.name, True,
                                           (e.fwd_thread, e.seq)))
        elif e.seq >= 0 and not e.fwd_thread:
            forward[(e.thread, e.seq)] = e          # the latest wins
    round_frames = sorted((f.start, f.end, f.name)
                          for fs in frames.values() for f in fs
                          if not f.backward and f.name.startswith(ROUND))
    main = Counter(t for t, fs in frames.items() for f in fs
                   if not f.backward and f.name.startswith(ROUND))
    main_thread = main.most_common(1)[0][0] if main else None

    w = tr.Window([(o.name, o.start, o.end) for o in ops])
    inside = [o for o in ops if tr.MARKER not in o.name
              and o.start >= w.t0 and o.end <= w.t1]

    # the stacks at each launch, then at the forward operation of each
    # backward launch
    queries: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i, o in enumerate(inside):
        if o.thread is not None:
            queries[o.thread].append((o.launch, i))
    at_launch: Dict[int, Tuple[_Frame, ...]] = {}
    for t, qs in queries.items():
        at_launch.update(_stacks(frames.get(t, []), qs))
    fwd_queries: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i, stack in at_launch.items():
        _, deep = _spans_of(stack)
        if deep is not None and deep.key in forward:
            fe = forward[deep.key]
            fwd_queries[fe.thread].append((fe.start, i))
    at_forward: Dict[int, Tuple[_Frame, ...]] = {}
    for t, qs in fwd_queries.items():
        at_forward.update(_stacks(frames.get(t, []), qs))

    attributed, early, unlinked = [], 0, 0
    rf_starts = [a for a, _, _ in round_frames]
    for i, o in enumerate(inside):
        names = set()
        if o.thread is None:
            unlinked += 1
        else:
            spans, _ = _spans_of(at_forward[i] if i in at_forward
                                 else at_launch.get(i, ()))
            names.update(f.name for f in spans)
        k = bisect.bisect_right(rf_starts, o.launch) - 1
        if k >= 0 and round_frames[k][1] >= o.launch:
            a, _, name = round_frames[k]
            names.add(name)
            if o.start < a:
                early += 1
        attributed.append((o.name, o.start, o.end, frozenset(names)))

    gap_list = w.gaps()
    main_frames = [f for f in frames.get(main_thread, [])
                   if not f.backward]
    at_gap = _stacks(main_frames, [((a + b) // 2, i)
                                   for i, (a, b) in enumerate(gap_list)])
    gaps = [(a, b, frozenset(f.name for f in at_gap[i]))
            for i, (a, b) in enumerate(gap_list)]
    seen = frozenset(f.name for fs in frames.values() for f in fs
                     if not f.backward)
    return Attribution(rounds=rounds, ops=attributed, gaps=gaps, seen=seen,
                       window_s=w.window_s, early=early, unlinked=unlinked)
