"""Seeded parameter construction with logical-axis bookkeeping, the
counterpart of ``repro/models/param.py``.

``ParamBuilder`` builds the same nested-dict tree as the JAX builder: the
same names, shapes and initial std (``shape[0] ** -0.5`` unless a scale is
given), and records, in a parallel tree of the same structure, the tuple
of *logical axis names* of every leaf (JAX's ``axes`` argument, copied at
each call site). Values come from one explicit ``torch.Generator`` and
differ from JAX's; tests that compare the two packages carry JAX's weights
over with ``models.convert.params_from_numpy``.

``build_abstract`` runs an ``init_fn`` on ``torch.device("meta")``: the
tree of shape-only tensors and the axes tree, without allocating a byte.
The dry run (``launch/dryrun.py``) resolves the axes against a mesh shape
and a rule table (``parallel/sharding.py``); the ``Trainer`` takes its
own axes tree (``models.transformer.param_axes``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]

META = torch.device("meta")


class ParamBuilder:
    """``generator`` None draws nothing: every leaf is ``torch.empty`` on
    ``device`` (the abstract build on meta; ``torch.Generator`` cannot be
    made there)."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device, path: str = "",
                 params: Optional[Dict] = None, axes: Optional[Dict] = None):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self._path = path
        self.params: Dict = {} if params is None else params
        self.axes: Dict = {} if axes is None else axes

    def scope(self, name: str) -> "ParamBuilder":
        sub_p = self.params.setdefault(name, {})
        sub_a = self.axes.setdefault(name, {})
        return ParamBuilder(self.generator, self.dtype, self.device,
                            f"{self._path}/{name}", sub_p, sub_a)

    def param(self, name: str, shape: Tuple[int, ...], axes: Axes,
              init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        assert len(shape) == len(axes), (self._path, name, shape, axes)
        if name in self.params:
            raise ValueError(f"duplicate param {self._path}/{name}")
        if init not in ("normal", "zeros", "ones", "uniform"):
            raise ValueError(f"unknown init {init!r}")
        kw = dict(dtype=self.dtype, device=self.device)
        if self.generator is None:
            v = torch.empty(shape, **kw)
        elif init == "normal":
            std = scale if scale is not None else shape[0] ** -0.5
            v = torch.randn(shape, generator=self.generator, **kw) * std
        elif init == "zeros":
            v = torch.zeros(shape, **kw)
        elif init == "ones":
            v = torch.ones(shape, **kw)
        else:                           # uniform in [-scale, scale), default 1
            lim = scale if scale is not None else 1.0
            v = (torch.rand(shape, generator=self.generator, **kw) * 2
                 - 1) * lim
        self.params[name] = v
        self.axes[name] = tuple(axes)
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


def build_abstract(init_fn: Callable[[ParamBuilder], None],
                   dtype: torch.dtype = torch.float32) -> Tuple[Dict, Dict]:
    """Shape-only init: (tree of meta tensors, axes tree). No allocation."""
    b = ParamBuilder(None, dtype, META)
    init_fn(b)
    return b.params, b.axes


def add_worker_axis(shapes: Dict, axes: Dict, n_workers: int,
                    skip: Optional[Callable[[str], bool]] = None
                    ) -> Tuple[Dict, Dict]:
    """Prefix every parameter leaf with the WASGD worker dimension.

    ``skip(path)`` selects leaves that stay single-copy (e.g. expert weights
    under expert parallelism). A meta leaf becomes a meta leaf of the
    stacked shape; a leaf with data is broadcast (a view)."""
    def _walk(s, a, path):
        if isinstance(s, dict):
            pairs = {k: _walk(s[k], a[k], f"{path}/{k}") for k in s}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if skip is not None and skip(path):
            return s, a
        shape = (n_workers,) + tuple(s.shape)
        new_s = (torch.empty(shape, dtype=s.dtype, device=META)
                 if s.is_meta else s.unsqueeze(0).expand(shape))
        return new_s, ("worker",) + tuple(a)

    return _walk(shapes, axes, "")


def is_expert_path(path: str) -> bool:
    """Leaves that are expert-parallel single copies (no worker dim)."""
    return "/experts/" in path or path.endswith("/experts")
