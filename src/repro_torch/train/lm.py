"""LM glue, the counterpart of ``repro/train/lm.py::make_lm_loss``: a
``ModelConfig`` wired into the ``loss_fn(params, batch)`` the round builder
and the ``Trainer`` take. (The JAX module's dry-run helpers
``abstract_lm_state`` and ``lm_batch_specs`` are not ported yet.)"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import loss_fn as lm_loss


def make_lm_loss(cfg: ModelConfig
                 ) -> Callable[[Dict, Dict], Tuple[torch.Tensor, Dict]]:
    """``loss(params, batch) -> (loss, {"ce", "moe_loss"})`` through the
    kernels (``models.transformer.loss_fn``'s defaults)."""
    def loss(params, batch):
        return lm_loss(cfg, params, batch)
    return loss
