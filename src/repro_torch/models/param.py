"""Seeded parameter construction, the counterpart of
``repro/models/param.py``.

``ParamBuilder`` builds the same nested-dict tree as the JAX builder: the
same names, shapes and initial std (``shape[0] ** -0.5`` unless a scale is
given). Values come from one explicit ``torch.Generator`` and differ from
JAX's; tests that compare the two packages carry JAX's weights over with
``models.convert.params_from_numpy``. The JAX builder's logical-axis tree
drives mesh sharding and has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


class ParamBuilder:
    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device, path: str = "",
                 params: Optional[Dict] = None):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self._path = path
        self.params: Dict = {} if params is None else params

    def scope(self, name: str) -> "ParamBuilder":
        sub = self.params.setdefault(name, {})
        return ParamBuilder(self.generator, self.dtype, self.device,
                            f"{self._path}/{name}", sub)

    def param(self, name: str, shape: Tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        if name in self.params:
            raise ValueError(f"duplicate param {self._path}/{name}")
        if init == "normal":
            std = scale if scale is not None else shape[0] ** -0.5
            v = torch.randn(shape, generator=self.generator, dtype=self.dtype,
                            device=self.device) * std
        elif init == "zeros":
            v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            v = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "uniform":         # in [-scale, scale), default 1
            lim = scale if scale is not None else 1.0
            v = (torch.rand(shape, generator=self.generator, dtype=self.dtype,
                            device=self.device) * 2 - 1) * lim
        else:
            raise ValueError(f"unknown init {init!r}")
        self.params[name] = v
        return v


def build(init_fn: Callable[[ParamBuilder], None], seed: int,
          dtype: torch.dtype, device: torch.device) -> Dict:
    """Runs ``init_fn`` with a builder drawing from a generator seeded with
    ``seed`` on ``device``; returns the parameter tree."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b = ParamBuilder(gen, dtype, device)
    init_fn(b)
    return b.params
