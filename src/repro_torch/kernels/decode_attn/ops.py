"""The two decode kernels in the model's ``(b, 1, h, hd)`` layout, the
counterparts of ``repro/kernels/decode_attn/ops.py:20``
(``decode_attention``, contiguous cache) and ``:32``
(``paged_decode_attention``).

A CPU tensor goes to the plain version and a CUDA tensor to the kernel
(the kernel's wrapper decides, from the tensors alone). ``kernel`` lets a
caller that compares the two on the card pass the plain version
explicitly; the serving engines never do.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.kernels.decode_attn.decode_attn import decode_attn
from repro_torch.kernels.decode_attn.paged import paged_decode_attn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     kernel: Callable = decode_attn) -> torch.Tensor:
    """q (b, 1, h, hd), caches (b, S, kv, hd), ``cache_len`` the number of
    valid positions (the new token's K/V already written at
    ``cache_len - 1``) -> (b, 1, h, hd)."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    out = kernel(qg, k_cache, v_cache, cache_len, window=window)
    return out.reshape(b, 1, h, hd)


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
