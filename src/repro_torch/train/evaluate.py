"""Held-out evaluation of a trained LM, the counterpart of
``repro/train/evaluate.py``: the consensus copy that is served, and its
perplexity and next-token accuracy."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aggregate import is_worker_leaf
from repro_torch.core.weights import equal_weights
from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.models.transformer import forward
from repro_torch.tree import tree_leaves, tree_map


def consensus_params(params: Dict, axes: Dict) -> Dict:
    """The beta=1 equal aggregation, then worker 0's slice: the served copy
    (after a beta=1 communication every worker holds it, Sec. 4.1). Each
    worker leaf's one row is ``theta @ x`` in float32, cast back to the
    leaf's dtype: with beta=1, Eq. 10's ``(1-beta) x + beta m`` is ``m``,
    and the p-row aggregate is never built (16 GB for gemma3-1b at p=4 in
    float32). Shared leaves pass through; a tree without a worker leaf
    comes back as it is."""
    p = next((x.shape[0] for x, ax in zip(tree_leaves(params),
                                          tree_leaves(axes))
              if is_worker_leaf(ax)), None)
    if p is None:
        return params
    theta = equal_weights(p, tree_leaves(params)[0].device)
    return tree_map(
        lambda x, ax: torch.tensordot(theta, x.float(), dims=1).to(x.dtype)
        if is_worker_leaf(ax) else x, params, axes)


@torch.no_grad()
def evaluate_lm(cfg: ModelConfig, params: Dict, batches, n_batches: int = 8
                ) -> Dict[str, float]:
    """Mean NLL, perplexity ``exp(min(nll, 30))`` and next-token accuracy
    over ``n_batches`` held-out batches (numpy dicts of ``tokens`` and
    ``labels``, and ``media`` for a model with cross layers) on the
    params' device. One forward a batch: its logits give the ``fused_ce``
    loss, as ``models.transformer.loss_fn`` computes its ``ce``, and the
    argmax (per codebook for an audio model, the accuracy their mean)."""
    dev = tree_leaves(params)[0].device
    nlls, accs = [], []
    for _ in range(n_batches):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(batches).items()}
        logits, _ = forward(cfg, params, batch["tokens"],
                            batch.get("media"))
        nlls.append(float(fused_ce(logits.float(), batch["labels"]).mean()))
        accs.append(float((torch.argmax(logits, dim=-1) == batch["labels"])
                          .float().mean()))
    nll = float(np.mean(nlls))
    return {"nll": nll, "ppl": float(np.exp(min(nll, 30.0))),
            "acc": float(np.mean(accs))}
