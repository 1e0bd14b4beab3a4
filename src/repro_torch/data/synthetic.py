"""Offline synthetic datasets, numpy copies of ``repro/data/synthetic.py``
(the same seeds give the same arrays as the JAX package's):

* ``make_classification``: teacher-labelled gaussian features, the MLP's
  stand-in for MNIST/Fashion-MNIST.
* ``make_images``: 28x28 class-templated images plus noise for the CNN,
  (n, 28, 28, 1) float32 (NHWC, as the JAX package makes them).
"""
from __future__ import annotations

from typing import Tuple

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
