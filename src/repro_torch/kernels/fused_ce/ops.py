"""The differentiable per-token cross-entropy the LM loss calls, the
counterpart of ``repro/kernels/fused_ce/ops.py``:
``models.transformer.loss_fn`` takes it by default, on every device
(``fused_ce.py`` picks the kernel or the plain version by the tensor's
device)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_ce.fused_ce import FusedCEFunction


def fused_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) float32; labels (...). Per-token ``logsumexp -
    label logit`` (...) float32, differentiable in the logits, also under
    ``torch.func``."""
    return FusedCEFunction.apply(logits, labels)[0]
