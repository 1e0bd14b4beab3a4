"""Optimizers over parameter trees: SGD, momentum SGD and AdamW, and the
gradient-norm and learning-rate helpers, the counterparts of
``repro/optim/optimizers.py``. Updates are element-wise, so the worker
dimension of the parameters is transparent, and write no tensor (new
tensors, as in the JAX package). Each optimizer is one per-leaf rule in
two forms:

``apply(grads, state, params) -> new_state``
    leaf-wise: one leaf at a time, its new tensor replaces the old one in
    ``params``' (and the state's) dicts and its gradient is popped from
    ``grads``, so the old value and the gradient are freed before the next
    leaf. The training round takes this form: it consumes its state, as
    JAX's donated step does, and holds parameters and gradients plus one
    leaf instead of three copies.
``update(grads, state, params) -> (new_params, new_state)``
    functional: ``apply`` on copies of the dicts, the inputs untouched."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Dict], Any]
    update: Callable[[Dict, Any, Dict], Tuple[Dict, Any]]
    name: str
    apply: Callable[[Dict, Any, Dict], Any]


class AdamState(NamedTuple):
    mu: Dict
    nu: Dict
    count: torch.Tensor       # int32 scalar


def _tree_zeros(params):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params)


def _dicts(tree):
    """A copy of a tree's dicts (and of an ``AdamState``'s) that shares its
    leaves."""
    if isinstance(tree, dict):
        return {k: _dicts(v) for k, v in tree.items()}
    if isinstance(tree, AdamState):
        return AdamState(_dicts(tree.mu), _dicts(tree.nu), tree.count)
    return tree


def _leafwise(fn: Callable, params: Dict, grads: Dict, *states: Dict
              ) -> None:
    """``fn(p, g, *s) -> (p', *s')`` leaf by leaf in sorted key order:
    each result replaces the leaf in ``params`` and ``states`` (in their
    dicts) and the gradient is popped from ``grads`` before the next."""
    for k in sorted(params):
        if isinstance(params[k], dict):
            _leafwise(fn, params[k], grads[k], *(s[k] for s in states))
            continue
        out = fn(params[k], grads.pop(k), *(s[k] for s in states))
        params[k] = out[0]
        for s, new in zip(states, out[1:]):
            s[k] = new


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales the whole gradient tree so that its global norm is at most
    ``max_norm``; returns (scaled tree, norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


def lr_schedule(kind: str, base_lr: float, warmup_steps: int = 0,
                total_steps: int = 10000, min_ratio: float = 0.1
                ) -> Callable[[Any], torch.Tensor]:
    """constant | linear_warmup | cosine (with linear warmup): a function
    of the step (an int or a tensor) to a float32 tensor."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp_max((step + 1) / max(warmup_steps, 1), 1.0)
        if kind == "constant":
            return base_lr * (warm if warmup_steps else torch.ones_like(step))
        if kind == "linear_warmup":
            return base_lr * warm
        if kind == "cosine":
            t = torch.clamp((step - warmup_steps)
                            / max(total_steps - warmup_steps, 1), 0, 1)
            cos = 0.5 * (1 + torch.cos(math.pi * t))
            return base_lr * warm * (min_ratio + (1 - min_ratio) * cos)
        raise ValueError(kind)
    return fn


def make_optimizer(name: str = "sgd", learning_rate: float = 1e-3,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                   ) -> Optimizer:
    lr = learning_rate

    if name == "sgd":
        def init(params):
            return ()

        def apply(grads, state, params):
            def leaf(p, g):
                pf, gf = p.float(), g.float()
                if weight_decay:
                    gf = gf + weight_decay * pf
                # p - lr * g, bit for bit (a - b is a + (-b) in IEEE, and
                # (-lr) * g is -(lr * g)), with one temporary the leaf's size
                return (torch.mul(gf, -lr).add_(pf).to(p.dtype),)
            _leafwise(leaf, params, grads)
            return state

    elif name == "momentum":
        def init(params):
            return _tree_zeros(params)

        def apply(grads, state, params):
            def leaf(p, g, m):
                m = torch.mul(m, momentum).add_(g.float())
                return torch.mul(m, -lr).add_(p.float()).to(p.dtype), m
            _leafwise(leaf, params, grads, state)
            return state

    elif name == "adamw":
        def init(params):
            dev = tree_leaves(params)[0].device
            return AdamState(_tree_zeros(params), _tree_zeros(params),
                             torch.zeros((), dtype=torch.int32, device=dev))

        def apply(grads, state, params):
            count = state.count + 1
            c1 = 1 - torch.pow(torch.full_like(count, b1, dtype=torch.float32),
                               count.float())
            c2 = 1 - torch.pow(torch.full_like(count, b2, dtype=torch.float32),
                               count.float())

            def leaf(p, g, m, v):
                m = b1 * m + (1 - b1) * g.float()
                v = b2 * v + (1 - b2) * torch.square(g.float())
                step = (m / c1) / (torch.sqrt(v / c2) + eps)
                pf = p.float()
                return (pf - lr * (step + weight_decay * pf)).to(p.dtype), m, v
            _leafwise(leaf, params, grads, state.mu, state.nu)
            return AdamState(state.mu, state.nu, count)
    else:
        raise ValueError(f"unknown optimizer {name!r}")

    def update(grads, state, params):
        """``apply`` on fresh dicts: new trees, the inputs untouched."""
        new_params = _dicts(params)
        new_state = apply(_dicts(grads), _dicts(state), new_params)
        return new_params, new_state

    return Optimizer(init, update, name, apply)
