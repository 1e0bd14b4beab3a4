"""The order-managed data pipeline (paper Alg. 1 lines 4-7 and OrderGen)
and the round prefetcher that feeds the pipelined round, the counterpart
of ``repro/data/pipeline.py``.

Each worker traverses the dataset in its own permutation order; the epoch
is split into ``n_segments`` order segments whose seeds survive or are
reshuffled from the Judge scores (``core/order.OrderState``). Round
batches are worker-major with leading dim ``p * tau * b_local``, the
train step's reshape contract.

``RoundPrefetcher`` builds and stages rounds on a background thread, so
the host's index/gather work for round ``r+1`` and its copy to the card,
with its first worker-major microbatch (which the pipelined round carries
through the aggregation's seam), happen while round ``r`` runs.

Under a device mesh (``core/shardmap_agg.py``) a round batch still holds
every worker's rows; ``rank_rows`` cuts a rank's shard's rows from it
(``Trainer(mesh=)`` does so once, ahead of the prefetcher).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.order import OrderState
from repro_torch.core.shardmap_agg import local_rows
from repro_torch.device import resolve_device


class OrderedDataset:
    def __init__(self, data: Dict[str, np.ndarray], n_workers: int, tau: int,
                 b_local: int, n_segments: int = 1,
                 order_state: Optional[OrderState] = None, seed: int = 0,
                 boundary_delay: int = 0):
        self.data = data
        self.n = len(next(iter(data.values())))
        self.p = n_workers
        self.tau = tau
        self.b_local = b_local
        self.n_segments = n_segments
        self.order = order_state or OrderState(n_workers, n_segments, seed)
        self.per_round = tau * b_local           # samples per worker per round
        self.seg_len = self.n // n_segments
        self.rounds_per_segment = max(1, self.seg_len // self.per_round)
        self.rounds_per_epoch = self.rounds_per_segment * n_segments
        # Rounds to wait after a segment boundary before that segment's
        # OrderGen decision is committed; 0 decides when the traversal
        # leaves the segment (Alg. 2). The round prefetcher's generator runs
        # up to ``RoundPrefetcher.run_ahead()`` rounds ahead of training, so
        # a delay of at least that keeps every round's Judge scores recorded
        # before the decision fires.
        self.boundary_delay = int(boundary_delay)

    def segment_of_round(self, r: int) -> int:
        return (r // self.rounds_per_segment) % self.n_segments

    def resize(self, new_p: int):
        """Membership resize at a round boundary: the rows of later rounds
        follow ``self.p``, and the order state's seed columns follow the
        slot contract (``OrderState.resize``). The Trainer then restarts
        ``batches`` at the round it resumes (``start_round=``); a generator
        already running keeps the old count."""
        if int(new_p) < 1:
            raise ValueError(f"resize needs new_p >= 1, got {new_p}")
        self.p = int(new_p)
        self.order.resize(self.p)

    def batches(self, start_round: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator over rounds, from round ``start_round`` (a
        resumed run picks up where its checkpoint left off). When the
        traversal leaves a segment, that segment's OrderGen decision
        (``OrderState.end_segment``) is due ``boundary_delay`` rounds later.
        A due decision whose round falls inside a new traversal of the same
        segment waits for that traversal's next boundary: the permutation
        is drawn from the seed every round, so a reshuffle mid-traversal
        would change the order under a pass in progress."""
        r = int(start_round)
        pending = []                     # (fire_at_round, segment) FIFO
        while True:
            seg = self.segment_of_round(r)
            within = r % self.rounds_per_segment
            if within == 0 and r > 0:
                pending.append((r + self.boundary_delay,
                                self.segment_of_round(r - 1)))
            while pending and pending[0][0] <= r:
                if pending[0][1] == seg and within != 0:
                    break                # never reshuffle mid-traversal
                self.order.end_segment(pending.pop(0)[1])
            idx = np.empty((self.p, self.per_round), np.int64)
            for w in range(self.p):
                perm = self.order.order_for(seg, w, self.seg_len)
                start = (within * self.per_round) % max(
                    1, self.seg_len - self.per_round + 1)
                sel = perm[start:start + self.per_round]
                if len(sel) < self.per_round:   # wrap
                    sel = np.concatenate(
                        [sel, perm[: self.per_round - len(sel)]])
                idx[w] = seg * self.seg_len + sel
            flat = idx.reshape(-1)               # worker-major
            yield {k: v[flat] for k, v in self.data.items()}
            r += 1


# ---------------------------------------------------------------------------
# Round prefetch: the host side of the pipelined round
# ---------------------------------------------------------------------------

def rank_rows(batch: Dict, n_workers: int, mesh) -> Dict:
    """This rank's shard's rows of a worker-major round batch of
    ``n_workers`` workers (views of numpy arrays or tensors)."""
    rows = local_rows(n_workers, mesh)

    def f(x):
        b = x.shape[0]
        if b % n_workers:
            raise ValueError(f"batch dim {b} not divisible by p = "
                             f"{n_workers}")
        per = b // n_workers
        return x[rows.start * per:rows.stop * per]

    return {k: f(v) for k, v in batch.items()}


def first_microbatch(batch: Dict, n_workers: int, tau: int) -> Dict:
    """The first worker-major microbatch of a round batch: every leaf has
    leading dim ``p * tau * b_local`` (worker-major), the result leading
    dims ``(p, b_local)``, leaf for leaf the ``t = 0`` slice of the train
    step's ``reshape_batch``, on which the pipelined round's parity rests.
    Numpy leaves give numpy views, tensors tensor views."""
    def f(x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        b = x.shape[0]
        if b % (tau * n_workers):
            raise ValueError(
                f"batch dim {b} not divisible by tau*p = {tau}*{n_workers}")
        bl = b // (tau * n_workers)
        return x.reshape(n_workers, tau, bl, *x.shape[1:])[:, 0]

    return {k: f(v) for k, v in batch.items()}


class _PrefetchError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _Staged:
    """A staged round: its batch and first microbatch on the device and,
    on a card, the event recorded after their copies."""

    def __init__(self, batch: Dict, first: Dict, event=None):
        self.batch, self.first, self.event = batch, first, event


_END = object()


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return torch.from_numpy(np.ascontiguousarray(x))


class RoundPrefetcher:
    """Round staging for the pipelined round.

    Wraps a round-batch iterator and yields ``(batch_r, first_{r+1})``,
    dicts of tensors on ``device`` (``None``: cuda), ``first_{r+1}`` being
    round ``r+1``'s first worker-major microbatch (``first_microbatch``).
    A daemon thread builds rounds ahead (``depth`` staged rounds queued).
    On a card it pins each round's batch and first microbatch, copies them
    with ``non_blocking=True`` on a side stream of ``device``, records an
    event and waits for it before it lets go of the pinned buffers; the
    consumer's stream waits on that event, and each staged tensor is
    marked used on that stream (``record_stream``), before ``__next__``
    hands it out.

    On a finite iterator the last pair reuses the last round's own first
    microbatch (there is no round ``r+1``); the pipelined round's seam
    output for it is never consumed.

    The upstream generator runs up to ``run_ahead()`` = depth + 2 rounds
    ahead of training (``depth`` queued, one blocked in the thread's
    ``put``, one held as the consumer's pair lookahead), so its side
    effects (``OrderedDataset``'s OrderGen decisions) fire that much
    early; ``OrderedDataset(boundary_delay=RoundPrefetcher.run_ahead())``
    re-aligns them with the recorded Judge scores.
    """

    DEFAULT_DEPTH = 2

    @classmethod
    def run_ahead(cls, depth: Optional[int] = None) -> int:
        """Worst-case rounds the upstream generator leads training by."""
        return (cls.DEFAULT_DEPTH if depth is None else depth) + 2

    def __init__(self, batches: Iterator[Dict], n_workers: int, tau: int,
                 depth: int = DEFAULT_DEPTH, device=None):
        self.n_workers = n_workers
        self.tau = tau
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = False
        self._cur: Optional[_Staged] = None
        self._done = False
        self._batches = iter(batches)
        self._thread = self._start()

    def _start(self) -> threading.Thread:
        t = threading.Thread(target=self._worker, daemon=True,
                             name="round-prefetch")
        t.start()
        return t

    def _stage(self, batch: Dict, stream) -> _Staged:
        host = {k: _host_tensor(v) for k, v in batch.items()}
        first = {k: v.contiguous() for k, v in first_microbatch(
            host, self.n_workers, self.tau).items()}
        if stream is None:                       # the CPU: nothing to copy
            return _Staged(host, first)
        host = {k: v.pin_memory() for k, v in host.items()}
        first = {k: v.pin_memory() for k, v in first.items()}
        with torch.cuda.stream(stream):
            dev_b = {k: v.to(self.device, non_blocking=True)
                     for k, v in host.items()}
            dev_f = {k: v.to(self.device, non_blocking=True)
                     for k, v in first.items()}
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()      # the pinned buffers may go after this
        return _Staged(dev_b, dev_f, event)

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._produce(torch.cuda.Stream(self.device))
            else:
                self._produce(None)
        except BaseException as e:                 # raised on the consumer
            self._put(_PrefetchError(e))

    def _produce(self, stream) -> None:
        for batch in self._batches:
            if self._stop or not self._put(self._stage(batch, stream)):
                return
        self._put(_END)

    def _get(self):
        item = self._q.get()
        if isinstance(item, _PrefetchError):
            self._done = True
            raise item.exc
        if isinstance(item, _Staged) and item.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(item.event)
            for t in (*item.batch.values(), *item.first.values()):
                t.record_stream(cur)
        return item

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[Dict, Dict]:
        if self._done:
            raise StopIteration
        if self._cur is None:
            head = self._get()
            if head is _END:
                self._done = True
                raise StopIteration
            self._cur = head
        nxt = self._get()
        cur = self._cur
        if nxt is _END:
            self._done = True
            return cur.batch, cur.first        # reuse own first microbatch
        self._cur = nxt
        return cur.batch, nxt.first

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    JOIN_TIMEOUT_S = 60.0

    def close(self):
        """Stops the staging thread, joins it and drops what it staged
        (safe to call again; the Trainer calls it when a pipelined run
        ends, also after an error). The thread checks the stop flag
        between rounds and while it waits on the full queue; one that
        does not stop within ``JOIN_TIMEOUT_S`` (an upstream iterator
        that blocks) raises."""
        self._stop = True
        self._drain()
        self._thread.join(timeout=self.JOIN_TIMEOUT_S)
        self._drain()
        self._cur = None
        if self._thread.is_alive():
            raise RuntimeError("round-prefetch thread did not stop within "
                               f"{self.JOIN_TIMEOUT_S} s")

    def resize(self, n_workers: int, batches: Optional[Iterator[Dict]] = None):
        """Membership resize: stops the staging thread (what it staged is
        laid out for the old worker count), then restarts staging from
        ``batches`` (a generator built for the new membership, e.g.
        ``OrderedDataset.batches(start_round=r)`` after
        ``OrderedDataset.resize``; by default the current upstream, right
        only if it now yields rounds of the new count). The pair lookahead
        resets, so the next ``__next__`` yields the first round of the new
        membership."""
        if int(n_workers) < 1:
            raise ValueError(f"resize needs n_workers >= 1, got {n_workers}")
        self.close()
        self.n_workers = int(n_workers)
        if batches is not None:
            self._batches = iter(batches)
        self._q = queue.Queue(maxsize=self._q.maxsize)
        self._stop = False
        self._cur = None
        self._done = False
        self._thread = self._start()
