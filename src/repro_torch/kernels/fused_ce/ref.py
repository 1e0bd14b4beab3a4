"""Plain PyTorch versions of the fused cross-entropy kernel.

``fused_ce_ref`` has the signature and semantics of
``repro/kernels/fused_ce/ref.py``: per-token ``logsumexp(logits) -
logits[label]`` in float32 (float64 for float64 logits, which the
gradient checks use). ``fused_ce_fwd_ref`` is the kernel's own
contract, which also returns the ``lse`` the backward pass reads. A label
outside ``[0, V)`` picks nothing (its nll is the lse), as in the CUDA
kernel and, for a negative label or one past its last vocab tile, in the
Pallas kernel.
The CPU path of the port runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fused_ce_fwd_ref(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V); labels (...) integer. Returns (nll, lse), each
    (...) float32."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    valid = (labels >= 0) & (labels < v)
    idx = labels.long().clamp(0, v - 1)
    picked = torch.gather(x, -1, idx[..., None])[..., 0]
    return lse - torch.where(valid, picked, torch.zeros_like(picked)), lse


def fused_ce_ref(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (T, V); labels (T,). Per-token nll (T,) float32."""
    return fused_ce_fwd_ref(logits, labels)[0]
