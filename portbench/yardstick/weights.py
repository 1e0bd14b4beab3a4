"""Seeded weights of a configuration, made on the device, in the layout of
the program's parameter tree (nested dicts of the same keys and shapes),
which the reference reads too.

Every leaf has a generator seed of its own, derived from the run's seed
and the leaf's path: one ``torch.randn`` call a leaf, on the card, in the
dtype asked for, and any one leaf can be made again alone (the training
check makes the initial weights again, leaf by leaf, to measure how far
training moved them). Matrices are normal with std ``fan_in ** -0.5``
(the contracted width), the embedding ``d ** -0.5``, the router 0.02,
RMSNorm scales ones."""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from portbench.yardstick.tokens import sub_seed
from portbench.yardstick.work import layer_is_moe, padded_vocab

Spec = Tuple[Tuple[str, ...], Tuple[int, ...], str]   # path, shape, init


def _layer_specs(cfg: Dict, i: int) -> List[Spec]:
    d, hd = cfg["d_model"], cfg["head_dim"]
    h, kv = cfg["n_heads"], cfg["n_kv_heads"]
    pre = ("layers", f"L{i}")
    out = [(pre + ("attn_norm", "scale"), (d,), "ones"),
           (pre + ("attn", "wq"), (d, h, hd), "fan_in:0"),
           (pre + ("attn", "wk"), (d, kv, hd), "fan_in:0"),
           (pre + ("attn", "wv"), (d, kv, hd), "fan_in:0"),
           (pre + ("attn", "wo"), (h, hd, d), "fan_in:01")]
    if layer_is_moe(cfg, i):
        m = cfg["moe"]
        e, f = m["n_experts"], m["d_ff_expert"]
        out += [(pre + ("ffn_norm", "scale"), (d,), "ones"),
                (pre + ("moe", "router"), (d, e), "router"),
                (pre + ("moe", "experts", "w_gate"), (e, d, f), "fan_in:1"),
                (pre + ("moe", "experts", "w_up"), (e, d, f), "fan_in:1"),
                (pre + ("moe", "experts", "w_down"), (e, f, d), "fan_in:1")]
    elif cfg.get("d_ff", 0) > 0:
        f = cfg["d_ff"]
        out += [(pre + ("ffn_norm", "scale"), (d,), "ones"),
                (pre + ("mlp", "w_gate"), (d, f), "fan_in:0"),
                (pre + ("mlp", "w_up"), (d, f), "fan_in:0"),
                (pre + ("mlp", "w_down"), (f, d), "fan_in:0")]
    return out


def leaf_specs(cfg: Dict) -> List[Spec]:
    """Every leaf of a dense or MoE decoder: (path, shape, init)."""
    d, v = cfg["d_model"], padded_vocab(cfg)
    out: List[Spec] = [(("embed", "tok"), (v, d), "embed")]
    for i in range(cfg["n_layers"]):
        out += _layer_specs(cfg, i)
    out.append((("final_norm", "scale"), (d,), "ones"))
    out.append((("head", "w"), (d, v), "fan_in:0"))
    return out


def _std(shape: Tuple[int, ...], init: str) -> float:
    if init == "embed":
        return shape[1] ** -0.5
    if init == "router":
        return 0.02
    dims = init.split(":")[1]
    return math.prod(shape[int(k)] for k in dims) ** -0.5


def make_leaf(spec: Spec, seed: int, device, dtype: torch.dtype
              ) -> torch.Tensor:
    """One leaf, the same values for the same (seed, path) every time."""
    path, shape, init = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights/" + "/".join(path)))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(_std(shape, init))


def make_tree(cfg: Dict, seed: int, device) -> Dict:
    """The whole parameter tree as nested dicts, in float32."""
    tree: Dict = {}
    for spec in leaf_specs(cfg):
        node = tree
        for k in spec[0][:-1]:
            node = node.setdefault(k, {})
        node[spec[0][-1]] = make_leaf(spec, seed, device, torch.float32)
    return tree


def get_path(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def walk(tree: Dict, prefix: Tuple[str, ...] = ()
         ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a nested dict in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def is_expert(path: Tuple[str, ...]) -> bool:
    """One copy that every worker trains (the program's ``experts`` axis)."""
    return "experts" in path
