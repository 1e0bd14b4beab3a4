"""Carries a parameter tree of the JAX package over to the port.

The JAX tree arrives with numpy leaves (``jax.tree.map(np.asarray, p)``
on the JAX side). Transformer and MLP leaves keep their name and einsum
layout: ``wq`` and ``wk``/``wv`` are ``(d, heads, hd)``, ``wo`` is
``(heads, hd, d)``, ``tok`` is ``(V, d)``, MLP weights are ``(d, f)`` /
``(f, d)``. No transposes, so the round trip is exact in float32 (and in
bfloat16).

CNN6 is the exception (``cnn6_from_jax`` / ``cnn6_to_jax``): conv weights
go HWIO -> OIHW, and the rows of ``fc_w`` are permuted from JAX's (h, w, c)
flatten of the (4, 4, 32) feature map to torch's (c, h, w). Both accept
leading worker dimensions, and both are exact (permutations only).
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


_CNN6_FEATURES = (4, 4, 32)                 # (h, w, c) before the head


def _cnn6_leaf_from_jax(name: str, a: np.ndarray) -> np.ndarray:
    if name.startswith("conv") and name.endswith("_w"):
        return np.moveaxis(a, (-4, -3, -2, -1), (-2, -1, -3, -4))
    if name == "fc_w":
        lead, n = a.shape[:-2], a.shape[-1]
        a = a.reshape(*lead, *_CNN6_FEATURES, n)
        return np.moveaxis(a, -2, -4).reshape(*lead, -1, n)
    return a


def _cnn6_leaf_to_jax(name: str, a: np.ndarray) -> np.ndarray:
    if name.startswith("conv") and name.endswith("_w"):
        return np.moveaxis(a, (-2, -1, -3, -4), (-4, -3, -2, -1))
    if name == "fc_w":
        lead, n = a.shape[:-2], a.shape[-1]
        h, w, c = _CNN6_FEATURES
        a = a.reshape(*lead, c, h, w, n)
        return np.moveaxis(a, -4, -2).reshape(*lead, -1, n)
    return a


def cnn6_from_jax(tree: Dict, device=None) -> Dict:
    """A JAX CNN6 tree of numpy leaves (optionally worker-stacked) -> the
    port's layout, as float32 tensors on ``device`` (``None``: cuda)."""
    return params_from_numpy(
        {k: np.ascontiguousarray(_cnn6_leaf_from_jax(k, np.asarray(v)))
         for k, v in tree.items()}, device=device)


def cnn6_to_jax(tree: Dict) -> Dict:
    """The port's CNN6 tree (optionally worker-stacked) -> numpy leaves in
    the JAX package's layout."""
    return {k: np.ascontiguousarray(
                _cnn6_leaf_to_jax(k, v.detach().cpu().numpy()))
            for k, v in tree.items()}
