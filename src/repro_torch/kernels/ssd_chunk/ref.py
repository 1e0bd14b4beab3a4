"""Plain PyTorch version of the Mamba2 SSD within-chunk kernel.

Same contract as ``repro/kernels/ssd_chunk/ref.py:8`` (``ssd_chunk_ref``):
per (batch, chunk, head), in float32,

    cum   = cumsum(dt * a)
    y     = [tril(exp(cum_i - cum_j)) * (C B^T) * dt_j] @ x
    state = (exp(cum_L - cum) * dt * B)^T @ x
    total = cum_L

The CPU path of the port runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_chunk_ref(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xs (b, nc, L, nh, hd); dt (b, nc, L, nh); a (nh,), or (b, nh) with
    one row of decay rates a batch row; B, C (b, nc, L, ds). Returns
    (y_diag (b, nc, L, nh, hd), states (b, nc, nh, ds, hd), totals
    (b, nc, nh)), all float32."""
    xs, dt, a, B, C = (t.float() for t in (xs, dt, a, B, C))
    L = xs.shape[2]
    if a.dim() == 2:
        a = a[:, None, None, :]
    cum = torch.cumsum(dt * a, dim=2)                 # (b, nc, L, nh)
    totals = cum[:, :, -1]                            # (b, nc, nh)

    cb = torch.einsum("bnls,bnms->bnlm", C, B)
    dmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xs.device))
    # the exponent is positive above the diagonal: mask before exp
    decay = torch.exp(torch.where(mask[None, None, :, :, None], dmat,
                                  torch.full_like(dmat, -float("inf"))))
    att = decay * cb[..., None] * dt[:, :, None, :, :]
    y = torch.einsum("bnlmh,bnmhd->bnlhd", att, xs)

    decay_to_end = torch.exp(totals[:, :, None, :] - cum) * dt
    states = torch.einsum("bnlh,bnls,bnlhd->bnhsd", decay_to_end, B, xs)
    return y, states, totals
