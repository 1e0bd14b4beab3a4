"""The order-managed data pipeline (paper Alg. 1 lines 4-7 and OrderGen),
a numpy copy of ``repro/data/pipeline.py::OrderedDataset``.

Each worker traverses the dataset in its own permutation order; the epoch
is split into ``n_segments`` order segments whose seeds survive or are
reshuffled from the Judge scores (``core/order.OrderState``). Round
batches are worker-major with leading dim ``p * tau * b_local``, the
train step's reshape contract.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.order import OrderState


class OrderedDataset:
    def __init__(self, data: Dict[str, np.ndarray], n_workers: int, tau: int,
                 b_local: int, n_segments: int = 1,
                 order_state: Optional[OrderState] = None, seed: int = 0):
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

    def segment_of_round(self, r: int) -> int:
        return (r // self.rounds_per_segment) % self.n_segments

    def resize(self, new_p: int):
        """Membership resize at a round boundary: the rows of later rounds
        follow ``self.p``, and the order state's seed columns follow the
        slot contract (``OrderState.resize``). The Trainer then restarts
        ``batches`` at the round it resumes (``start_round=``)."""
        if int(new_p) < 1:
            raise ValueError(f"resize needs new_p >= 1, got {new_p}")
        self.p = int(new_p)
        self.order.resize(self.p)

    def batches(self, start_round: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator over rounds, from round ``start_round`` (a
        resumed run picks up where its checkpoint left off). When the
        traversal leaves a segment, that segment's OrderGen keep-or-reshuffle
        decision fires (``OrderState.end_segment``), before the next round
        is built."""
        r = int(start_round)
        while True:
            seg = self.segment_of_round(r)
            within = r % self.rounds_per_segment
            if within == 0 and r > 0:
                self.order.end_segment(self.segment_of_round(r - 1))
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
