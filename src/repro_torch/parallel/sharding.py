"""Logical-axis sharding rules, the counterpart of
``repro/parallel/sharding.py``.

Parameters and inputs are annotated with *logical* axis names
(``"worker"``, ``"heads"``, ``"ffn"`` ...; ``models/param.py``). A rule
table maps logical names to physical mesh axes; ``spec_for`` resolves a
tuple of logical names and a concrete shape into a spec, one entry a
dimension (``None``, a mesh axis name or a tuple of names), falling back
to replication for any dimension the mesh axis does not divide evenly
(e.g. gemma3's 4 query heads over a 16-way model axis, or yi's 4 KV
heads), and keeping only the first use of a mesh axis.

The tables are JAX's, verbatim. Only the dry run (``launch/dryrun.py``)
applies them: the port's ``Trainer`` holds its worker rows cut over the
worker axes and no tensor parallelism (``train/trainer.py``). A spec is a
plain tuple; JAX's ``NamedSharding`` (a spec bound to a device mesh for
``jax.jit``) has no counterpart, since nothing here places an array by a
spec. ``mesh`` is anything with a ``.shape`` mapping from axis name to
size (``MeshShape``, JAX's own ``Mesh``), or a
``torch.distributed.device_mesh.DeviceMesh`` through its
``mesh_dim_names``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple, Union

import torch

LogicalAxes = Tuple[Optional[str], ...]
Rule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Rule, ...]


# Default rule tables ---------------------------------------------------------

# Training: the WASGD worker axis spans ("pod", "data"); tensor parallelism
# spans "model". Batch inside a worker is NOT sharded (each worker is one
# data-parallel group).
TRAIN_RULES: Dict[str, Rule] = {
    "worker": ("pod", "data"),
    "batch": None,
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "data",          # expert-parallel single copy over the worker axis
    "expert_ffn": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "media": None,
    "kv_seq": None,
}

# Serving (no worker axis): batch over ("pod","data"), TP over "model".
SERVE_RULES: Dict[str, Rule] = {
    **TRAIN_RULES,
    "worker": None,
    "batch": ("pod", "data"),
    "experts": "model",         # single-copy serving: EP folds into the TP axis
    "expert_ffn": None,
    # KV caches dominate decode memory: when kv_heads < model-axis size the
    # heads dim falls back to replicated and the head_dim picks up "model"
    # (the PartitionSpec dedupe keeps whichever resolves first).
    "head_dim": "model",
}

# Long-context serving (batch=1): shard the KV-cache/sequence dim over "data"
# (flash-decode partial-softmax combine), batch replicated.
SERVE_LONG_RULES: Dict[str, Rule] = {
    **SERVE_RULES,
    "batch": None,
    "kv_seq": "data",
    "seq": "data",
}


class MeshShape:
    """A mesh by its shape alone: ``MeshShape({"data": 16, "model": 16})``.
    The dry run's production meshes are these; nothing is placed."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape: Dict[str, int] = dict(shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """The ``{axis name: size}`` of ``mesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: Mapping[str, int], rule: Rule) -> int:
    if rule is None:
        return 1
    names = (rule,) if isinstance(rule, str) else rule
    size = 1
    for n in names:
        if n in shape:
            size *= shape[n]
    return size


def _present(shape: Mapping[str, int], rule: Rule) -> Rule:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' single-pod)."""
    if rule is None:
        return None
    names = (rule,) if isinstance(rule, str) else rule
    kept = tuple(n for n in names if n in shape)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def spec_for(mesh, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             rules: Optional[Mapping[str, Rule]] = None) -> Spec:
    """Resolve logical axes (+ optional concrete shape) to a spec: one
    entry a dimension."""
    ms = mesh_shape(mesh)
    rules = TRAIN_RULES if rules is None else rules
    out = []
    for i, name in enumerate(axes):
        rule = _present(ms, rules.get(name)) if name is not None else None
        if rule is not None and shape is not None:
            if shape[i] % _axis_size(ms, rule) != 0:
                rule = None  # divisibility fallback: replicate this dim
        out.append(rule)
    # a mesh axis shards one dimension at most; keep the first occurrence
    seen: set = set()
    cleaned = []
    for rule in out:
        names = () if rule is None else ((rule,) if isinstance(rule, str)
                                         else tuple(rule))
        if any(n in seen for n in names):
            cleaned.append(None)
        else:
            seen.update(names)
            cleaned.append(rule)
    return tuple(cleaned)


# Trees of the dry run: dicts (sorted keys), tuples and NamedTuples; a
# tensor is a leaf, its axes tuple the leaf at the same place of the axes
# tree; a host value (``TrainState.step``) is a leaf with axes ().

def map_with_axes(fn: Callable, shapes: Any, axes: Any) -> Any:
    """``fn(leaf, its axes)`` over a shapes tree, in a tree of the same
    structure."""
    if isinstance(shapes, dict):
        return {k: map_with_axes(fn, shapes[k], axes[k])
                for k in sorted(shapes)}
    if isinstance(shapes, (tuple, list)):
        items = [map_with_axes(fn, s, a) for s, a in zip(shapes, axes)]
        if hasattr(shapes, "_fields"):          # a NamedTuple
            return type(shapes)(*items)
        return type(shapes)(items)
    return fn(shapes, axes)


def leaves_with_axes(shapes: Any, axes: Any) -> List[Tuple[torch.Tensor,
                                                            LogicalAxes]]:
    """The (tensor, axes) pairs of a shapes tree and its axes tree, in
    ``jax.tree`` order; host values are left out."""
    out: List = []

    def visit(s, a):
        if isinstance(s, torch.Tensor):
            out.append((s, tuple(a)))

    map_with_axes(visit, shapes, axes)
    return out


def tree_specs(mesh, shapes_tree: Any, axes_tree: Any,
               rules: Optional[Mapping[str, Rule]] = None) -> Any:
    """The spec of every tensor leaf of ``shapes_tree`` (JAX's
    ``tree_shardings`` without the device mesh), in a tree of the same
    structure; a host value's place holds ``()``. The shapes tree leads,
    so an empty container (an SGD optimizer state of ``()``) holds no
    spec."""
    def one(s, a):
        if isinstance(s, torch.Tensor):
            return spec_for(mesh, a, tuple(s.shape), rules)
        return ()
    return map_with_axes(one, shapes_tree, axes_tree)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of an array of ``shape`` laid out by ``spec``."""
    ms = mesh_shape(mesh)
    return tuple(n // _axis_size(ms, rule)
                 for n, rule in zip(shape, tuple(spec) + (None,) * len(shape)))


def num_workers(mesh) -> int:
    """WASGD worker count = product of the worker-axis mesh dims."""
    ms = mesh_shape(mesh)
    return _axis_size(ms, _present(ms, TRAIN_RULES["worker"]))


def bytes_of(shape: Sequence[int], dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def tree_bytes(shapes_tree: Any, axes_tree: Any, mesh=None,
               rules: Optional[Mapping[str, Rule]] = None) -> int:
    """The bytes of a tree's tensors: whole, or with ``mesh`` one device's
    blocks under ``rules`` (the dry run's argument bytes)."""
    total = 0
    for s, a in leaves_with_axes(shapes_tree, axes_tree):
        shape = tuple(s.shape)
        if mesh is not None:
            shape = shard_shape(shape, spec_for(mesh, a, shape, rules), mesh)
        total += bytes_of(shape, s.dtype)
    return total
