"""Seeded inputs: the token streams of training. Everything is drawn from ``numpy.random.default_rng`` of a seed
derived from the run's ``--seed``, so one seed gives the same inputs on
any machine, and the program receives only the arrays."""
from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one use (``label``) of the run's seed, so that
    the inputs, the weights and the order do not share a stream."""
    h = hashlib.blake2b(f"{int(seed)}:{label}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def _zipf_sampler(rng: np.random.Generator, vocab: int, s: float):
    """Draws of a Zipf(s) law over ``vocab`` ids, the ranks given to the
    ids by a random permutation."""
    weights = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(weights / weights.sum())
    ids = rng.permutation(vocab)

    def draw(n: int) -> np.ndarray:
        r = np.searchsorted(cdf, rng.random(n), side="right")
        return ids[np.minimum(r, vocab - 1)]
    return draw


def zipf_bigram(seed: int, n_seq: int, length: int, vocab: int,
                zipf_s: float = 1.1, p_follow: float = 0.5) -> np.ndarray:
    """(n_seq, length) int32 token streams over the whole vocabulary: the
    first token and every token that does not follow the bigram map come
    from a Zipf law; a token follows its predecessor's fixed successor
    (a random permutation) with probability ``p_follow``."""
    rng = np.random.default_rng(sub_seed(seed, "tokens"))
    draw = _zipf_sampler(rng, vocab, zipf_s)
    succ = rng.permutation(vocab)
    toks = np.empty((n_seq, length), np.int64)
    toks[:, 0] = draw(n_seq)
    for t in range(1, length):
        follow = rng.random(n_seq) < p_follow
        toks[:, t] = np.where(follow, succ[toks[:, t - 1]], draw(n_seq))
    return toks.astype(np.int32)


def lm_data(seed: int, data: Dict, seq_len: int, vocab: int
            ) -> Dict[str, np.ndarray]:
    """The training set a traffic file's ``data`` block describes:
    ``tokens`` and ``labels`` (n_seq, seq_len), labels shifted by one."""
    if data["generator"] != "zipf_bigram":
        raise ValueError(f"unknown token generator {data['generator']!r}")
    toks = zipf_bigram(seed, data["n_seq"], seq_len + 1, vocab,
                       data.get("zipf_s", 1.1), data.get("p_follow", 0.5))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
