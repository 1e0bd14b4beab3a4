"""Carries a parameter tree of the JAX package over to the port.

The JAX tree arrives with numpy leaves (``jax.tree.map(np.asarray, p)``
on the JAX side). Every leaf keeps its name and its einsum layout: ``wq``
and ``wk``/``wv`` are ``(d, heads, hd)``, ``wo`` is ``(heads, hd, d)``,
``tok`` is ``(V, d)``, MLP weights are ``(d, f)`` / ``(f, d)``. No
transposes, so the round trip is exact in float32 (and in bfloat16).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import dtype_of
from repro_torch.device import resolve_device


def _leaf(a, device: torch.device, dtype: Optional[torch.dtype]):
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict, device=None, dtype=None) -> Dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (``None``: cuda), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    dt = None if dtype is None else dtype_of(dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, dev, dt)

    return walk(tree)
