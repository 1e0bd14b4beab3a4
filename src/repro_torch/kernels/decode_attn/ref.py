"""Plain PyTorch versions of the two decode-attention kernels.

``decode_attn_ref`` has the contract of
``repro/kernels/decode_attn/ref.py:12``: one query token against a
contiguous cache, valid positions ``pos < cache_len`` (and, with a window,
``cache_len - 1 - pos < window``). ``paged_decode_attn_ref`` has the
signature and masking of ``repro/kernels/decode_attn/paged.py:141``: gather
the block table first. Both run masked softmax attention in float32 and
return ``q.dtype``. The CPU path of the port runs them, and
``chip_smoke.py`` holds the CUDA kernels to them on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache_len: Union[int, torch.Tensor], *,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (b, kv, g, hd); k, v: (b, S, kv, hd); ``cache_len`` a scalar
    (int or 0-d tensor) for the whole batch -> (b, kv, g, hd)."""
    hd = q.shape[-1]
    S = k.shape[1]
    qf = q.float() * hd ** -0.5
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float())
    pos = torch.arange(S, device=q.device)
    valid = pos < cache_len         # an int stays on the host: no copy
    if window is not None:
        valid &= (cache_len - 1 - pos) < window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.to(q.dtype)


def check_ring(ring: Optional[int], n_blk: int, bs: int) -> None:
    if ring is not None and ring != n_blk * bs:
        raise ValueError(
            f"ring capacity {ring} != table blocks x block_size "
            f"({n_blk}x{bs})")


def slot_valid(slot: torch.Tensor, index: torch.Tensor, ring: Optional[int],
               window: Optional[int]) -> torch.Tensor:
    """Validity of cache ``slot`` for a request whose newest token sits at
    ``index`` (broadcasting). Linear: ``slot <= index``. Ring:
    ``(index - slot) mod ring < min(window, index + 1)``."""
    if ring is None:
        return slot <= index
    age = torch.remainder(index - slot, ring)
    lim = torch.clamp(index + 1, max=ring if window is None else window)
    return age < lim


def paged_decode_attn_ref(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          index: torch.Tensor, *, ring: Optional[int] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """q: (b, kv, g, hd); pools: (n_pool, bs, kv, hd); block_table:
    (b, n_blk) int32; index: (b,) int32 position of each newest token."""
    b, kv, g, hd = q.shape
    bs = k_pool.shape[1]
    n_blk = block_table.shape[1]
    check_ring(ring, n_blk, bs)
    S = n_blk * bs
    tab = block_table.long()
    k = k_pool[tab].reshape(b, S, kv, hd).float()
    v = v_pool[tab].reshape(b, S, kv, hd).float()
    qg = q.float() * hd ** -0.5
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    slot = torch.arange(S, device=q.device, dtype=torch.int64)
    valid = slot_valid(slot[None, :], index.long()[:, None], ring, window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    return out.to(q.dtype)
