"""The work a kernel or a model step must do, from shapes alone: bytes a
call must move (each input byte read once, each output byte written
once) and the operations the model needs. Frozen copies of the
arithmetic of ``chip_smoke.py`` (``wagg_work``, ``norm_work``,
``phase_ce_time``'s bytes), so that the program's
changes cannot move the yardstick. ``cfg`` is a configuration file's
``model`` block (a dict)."""
from __future__ import annotations

import math
from typing import Dict


def padded_vocab(cfg: Dict) -> int:
    return int(math.ceil(cfg["vocab_size"] / 256) * 256)


# -- kernels ----------------------------------------------------------------

def wagg_bytes(p: int, n: int, x_bytes: int, q_bytes: int,
               masked: bool = False) -> int:
    """One leaf of the Eq. 10 aggregate: x (p, n) read once and written
    once, the codec's payload (``q_bytes`` an element, 0 where x is its
    own payload) read once, theta (and the mask) read."""
    return p * n * (2 * x_bytes + q_bytes) + p * 4 * (2 if masked else 1)


def norm_bytes(rows: int, d: int, x_bytes: int, groups: int,
               fused: bool = False) -> int:
    """One RMSNorm launch: x read and y written (fused: delta read and the
    sum written too), the ``groups`` scales read, rstd written."""
    arrays = 4 if fused else 2
    return arrays * rows * d * x_bytes + groups * d * 4 + rows * 4


def ce_bytes(rows: int, vocab: int) -> int:
    """One fused cross-entropy launch: float32 logits read once, the
    labels read, nll and lse written."""
    return rows * vocab * 4 + rows * 4 + 2 * rows * 4


# -- model operations -----------------------------------------------------------

def layer_is_moe(cfg: Dict, i: int) -> bool:
    moe = cfg.get("moe")
    every = cfg.get("moe_every", 1)
    return moe is not None and i % every == every - 1


def active_matmul_params(cfg: Dict) -> int:
    """Matrix parameters one token multiplies by: attention projections,
    the router and top_k of n_experts (or the dense MLP) in every layer,
    and the LM head; the embedding is a gather and counts nothing."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    n = 0
    for i in range(cfg["n_layers"]):
        n += d * q + 2 * d * kv + q * d
        if layer_is_moe(cfg, i):
            m = cfg["moe"]
            n += d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
        elif cfg.get("d_ff", 0) > 0:
            n += 3 * d * cfg["d_ff"]
    return n + d * padded_vocab(cfg)


def attention_flops(cfg: Dict, q_len: int, k_len: int) -> float:
    """Forward q.k and p.v products of every layer for ``q_len`` queries
    against ``k_len`` keys each (causal prefill: pass the mean key count)."""
    return (4.0 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"]
            * q_len * k_len)


def train_flops_per_sequence(cfg: Dict, seq: int) -> float:
    """Model operations of one sequence's forward and backward: 6 per
    active matrix parameter and token, plus the causal attention products
    three times (forward, and two in the backward); recompute under remat
    is not counted."""
    causal_keys = (seq + 1) / 2.0
    return (6.0 * active_matmul_params(cfg) * seq
            + 3.0 * attention_flops(cfg, seq, causal_keys))
