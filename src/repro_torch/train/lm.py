"""LM glue, the counterpart of ``repro/train/lm.py::make_lm_loss``: a
``ModelConfig`` wired into the ``loss_fn(params, batch)`` the round builder
and the ``Trainer`` take. (The JAX module's dry-run helpers
``abstract_lm_state`` and ``lm_batch_specs`` are not ported yet.)

The loss also has the model's worker-stacked form, ``loss.stacked``
(``models.transformer.worker_losses``; ``train.step.StackedLoss``): the
round takes it in place of a ``vmap`` of the whole loss, so that
``cfg.remat`` can checkpoint each layer outside its ``vmap``."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.ssd_chunk import ssd_chunked_kernel
from repro_torch.models.transformer import loss_fn as lm_loss
from repro_torch.models.transformer import worker_losses


class LMLoss:
    """``loss(params, batch) -> (loss, {"ce", "moe_loss"})`` of one model
    and ``loss.stacked(params, in_dims, batch) -> (losses (p,), aux)`` of
    worker-stacked params, both through ``norm``, ``ce`` and ``ssd``."""

    def __init__(self, cfg: ModelConfig, norm: Callable, ce: Callable,
                 ssd: Callable):
        self.cfg, self.norm, self.ce, self.ssd = cfg, norm, ce, ssd

    def __call__(self, params: Dict, batch: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
        return lm_loss(self.cfg, params, batch, norm=self.norm, ce=self.ce,
                       ssd=self.ssd)

    def stacked(self, params: Dict, in_dims: Dict, batch: Dict
                ) -> Tuple[torch.Tensor, Dict]:
        return worker_losses(self.cfg, params, in_dims, batch,
                             norm=self.norm, ce=self.ce, ssd=self.ssd)


def make_lm_loss(cfg: ModelConfig, *, norm: Callable = rmsnorm_kernel,
                 ce: Callable = fused_ce,
                 ssd: Callable = ssd_chunked_kernel) -> LMLoss:
    """The loss of ``cfg`` through the kernels (``models.transformer.
    loss_fn``'s defaults), or through ``norm``, ``ce`` and ``ssd`` when
    given (the kernels' plain versions, for an agreement check)."""
    return LMLoss(cfg, norm, ce, ssd)
