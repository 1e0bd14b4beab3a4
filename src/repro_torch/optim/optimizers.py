"""Optimizers over parameter trees: SGD, momentum SGD and AdamW, and the
gradient-norm and learning-rate helpers, the counterparts of
``repro/optim/optimizers.py``. Updates are functional
(new tensors, as in the JAX package) and element-wise, so the worker
dimension of the parameters is transparent."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Dict], Any]
    update: Callable[[Dict, Any, Dict], Tuple[Dict, Any]]
    name: str


class AdamState(NamedTuple):
    mu: Dict
    nu: Dict
    count: torch.Tensor       # int32 scalar


def _tree_zeros(params):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params)


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

        def upd(p, g):
            pf, gf = p.float(), g.float()
            if weight_decay:
                gf = gf + weight_decay * pf
            return (pf - lr * gf).to(p.dtype)

        def update(grads, state, params):
            return tree_map(upd, params, grads), state

    elif name == "momentum":
        def init(params):
            return _tree_zeros(params)

        def update(grads, state, params):
            new_m = tree_map(lambda m, g: momentum * m + g.float(), state,
                             grads)
            new_p = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                             params, new_m)
            return new_p, new_m

    elif name == "adamw":
        def init(params):
            dev = tree_leaves(params)[0].device
            return AdamState(_tree_zeros(params), _tree_zeros(params),
                             torch.zeros((), dtype=torch.int32, device=dev))

        def update(grads, state, params):
            count = state.count + 1
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                          state.mu, grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                          * torch.square(g.float()), state.nu, grads)
            c1 = 1 - torch.pow(torch.full_like(count, b1, dtype=torch.float32),
                               count.float())
            c2 = 1 - torch.pow(torch.full_like(count, b2, dtype=torch.float32),
                               count.float())

            def upd(p, m, v):
                step = (m / c1) / (torch.sqrt(v / c2) + eps)
                pf = p.float()
                return (pf - lr * (step + weight_decay * pf)).to(p.dtype)

            return (tree_map(upd, params, mu, nu), AdamState(mu, nu, count))
    else:
        raise ValueError(f"unknown optimizer {name!r}")

    return Optimizer(init, update, name)
