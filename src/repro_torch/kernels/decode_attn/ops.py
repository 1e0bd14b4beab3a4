"""The paged decode kernel in the model's ``(b, 1, h, hd)`` layout, the
counterpart of ``repro/kernels/decode_attn/ops.py:32``.

A CPU tensor goes to the plain version and a CUDA tensor to the kernel
(``paged.paged_decode_attn`` decides, from the tensor alone). ``kernel``
lets a caller that compares the two on the card pass the plain version
explicitly; the serving engine never does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.decode_attn.paged import paged_decode_attn


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           index: torch.Tensor, *, ring: Optional[int] = None,
                           window: Optional[int] = None,
                           kernel: Callable = paged_decode_attn
                           ) -> torch.Tensor:
    """q (b, 1, h, hd), pools (n_pool, block_size, kv, hd), block_table
    (b, n_blk) int32, index (b,) int32 -> (b, 1, h, hd)."""
    b, _, h, hd = q.shape
    kv = k_pool.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    out = kernel(qg, k_pool, v_pool, block_table, index, ring=ring,
                 window=window)
    return out.reshape(b, 1, h, hd)
