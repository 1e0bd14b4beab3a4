"""Offline synthetic datasets, numpy copies of ``repro/data/synthetic.py``
(the same seeds give the same arrays as the JAX package's):

* ``make_classification``: teacher-labelled gaussian features, the MLP's
  stand-in for MNIST/Fashion-MNIST.
* ``make_images``: 28x28 class-templated images plus noise for the CNN,
  (n, 28, 28, 1) float32 (NHWC, as the JAX package makes them).
* ``make_tokens`` / ``lm_batch``: token streams with a learnable bigram
  structure (a noisy random permutation map) for LM training.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_classification(seed: int, n: int, d: int = 64, n_classes: int = 10,
                        noise: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, d)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + noise * rng.normal(size=(n, d)).astype(np.float32)
    # nonlinear warp so the problem isn't linearly trivial
    w = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    x = np.tanh(x @ w) + noise * rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def make_images(seed: int, n: int, n_classes: int = 10, size: int = 28,
                noise: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_classes, size, size, 1)).astype(np.float32)
    # low-pass the templates so classes have spatial structure
    for _ in range(2):
        templates = (templates
                     + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)) / 5
    y = rng.integers(0, n_classes, size=n)
    x = templates[y] + noise * rng.normal(size=(n, size, size, 1))
    return x.astype(np.float32), y.astype(np.int32)


def make_tokens(seed: int, n_seq: int, seq_len: int, vocab: int,
                p_follow: float = 0.8) -> np.ndarray:
    """Noisy-permutation bigram language: t+1 = perm[t] w.p. p_follow."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    toks = np.empty((n_seq, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n_seq)
    for t in range(seq_len):
        follow = rng.random(n_seq) < p_follow
        rand = rng.integers(0, vocab, size=n_seq)
        toks[:, t + 1] = np.where(follow, perm[toks[:, t]], rand)
    return toks


def lm_batch(seed: int, batch: int, seq_len: int, vocab: int,
             n_codebooks: int = 0, media_tokens: int = 0, d_model: int = 0
             ) -> Dict[str, np.ndarray]:
    """One LM training batch (tokens/labels [+ media embeddings stub])."""
    rng = np.random.default_rng(seed)
    if n_codebooks > 0:
        toks = rng.integers(0, vocab, size=(batch, seq_len + 1, n_codebooks),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    else:
        toks = make_tokens(seed, batch, seq_len, vocab)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if media_tokens > 0:
        out["media"] = rng.normal(
            size=(batch, media_tokens, d_model)).astype(np.float32)
    return out
