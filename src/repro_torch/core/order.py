"""Sample-order search (paper Sec. 3.4, Alg. 2 ``Judge``/``OrderGen``), the
counterpart of ``repro/core/order.py``.

At each communication the workers' loss energies are z-scored
(``judge_scores``, on the device); a worker whose accumulated score is
<= ``keep_score`` keeps its permutation seed for the next pass over the
segment, every other worker reshuffles (``OrderState.end_segment``). The
seeds come from numpy, so the orders are those of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def judge_scores(h: torch.Tensor) -> torch.Tensor:
    """Alg. 2 Function 3: z-score of each worker's loss energy."""
    h = h.float()
    ave = h.mean()
    stdv = torch.sqrt(torch.clamp_min(
        torch.sum(torch.square(h - ave)) / max(h.shape[0] - 1, 1), 1e-30))
    return (h - ave) / stdv


def permutation(seed: int, length: int) -> np.ndarray:
    """Deterministic sample order from a seed (host-side pipeline)."""
    return np.random.default_rng(int(seed)).permutation(length)


class OrderState:
    """Per-(segment, worker) permutation seeds and accumulated scores."""

    def __init__(self, n_workers: int, n_segments: int, base_seed: int = 0,
                 keep_score: float = -1.0):
        rng = np.random.default_rng(base_seed)
        self.seeds = rng.integers(0, 2**31 - 1, size=(n_segments, n_workers))
        self.scores = np.zeros((n_segments, n_workers), np.float64)
        self.keep_score = float(keep_score)
        self._rng = rng

    def order_for(self, segment: int, worker: int, length: int) -> np.ndarray:
        return permutation(self.seeds[segment, worker], length)

    def record_scores(self, segment: int, scores: np.ndarray):
        """Accumulate communication-time Judge scores for this segment."""
        self.scores[segment] += np.asarray(scores)

    def end_segment(self, segment: int) -> np.ndarray:
        """Alg. 2 OrderGen: keep seeds whose total score <= keep_score;
        returns the keep mask."""
        keep = self.scores[segment] <= self.keep_score
        n = (~keep).sum()
        if n:
            self.seeds[segment, ~keep] = self._rng.integers(0, 2**31 - 1,
                                                            size=n)
        self.scores[segment] = 0.0
        return keep

    def resize(self, new_p: int):
        """Membership resize with the slot contract: worker ``i`` keeps its
        seed column for ``i < min(old_p, new_p)``; newcomers draw fresh
        seeds from this state's generator and start their score at 0."""
        if int(new_p) < 1:
            raise ValueError(f"resize needs new_p >= 1, got {new_p}")
        new_p = int(new_p)
        old_p = self.seeds.shape[1]
        if new_p <= old_p:
            self.seeds = self.seeds[:, :new_p]
            self.scores = self.scores[:, :new_p]
        else:
            n_seg = self.seeds.shape[0]
            fresh = self._rng.integers(0, 2**31 - 1,
                                       size=(n_seg, new_p - old_p))
            self.seeds = np.concatenate([self.seeds, fresh], axis=1)
            self.scores = np.concatenate(
                [self.scores, np.zeros((n_seg, new_p - old_p))], axis=1)


def grouped_order(labels: np.ndarray, delta: int, seed: int = 0
                  ) -> np.ndarray:
    """A sample order with runs of ``delta`` same-label samples (the
    paper's Sec. 5.1 order-effect experiment)."""
    rng = np.random.default_rng(seed)
    by_label = {}
    for idx, lab in enumerate(labels):
        by_label.setdefault(int(lab), []).append(idx)
    for v in by_label.values():
        rng.shuffle(v)
    runs = []
    pools = {k: list(v) for k, v in by_label.items()}
    while any(pools.values()):
        keys = [k for k, v in pools.items() if v]
        k = keys[rng.integers(len(keys))]
        take = min(delta, len(pools[k]))
        runs.extend(pools[k][:take])
        pools[k] = pools[k][take:]
    return np.asarray(runs)
