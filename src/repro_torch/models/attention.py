"""GQA attention for prefill: chunked (flash-style) softmax over key blocks
with causal and sliding-window masking, the counterpart of
``flash_attention`` and ``_block_mask`` in ``repro/models/attention.py``.

Plain torch ops, chunked over keys like the JAX version so that peak
memory stays O(seq * block); the JAX version is no Pallas kernel, so
neither is this.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.param import ParamBuilder

NEG_INF = -1e30


def attention_init(b: ParamBuilder, name: str, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int):
    s = b.scope(name)
    s.param("wq", (d_model, n_heads, head_dim))
    s.param("wk", (d_model, n_kv_heads, head_dim))
    s.param("wv", (d_model, n_kv_heads, head_dim))
    s.param("wo", (n_heads, head_dim, d_model))


class KVCache(NamedTuple):
    k: torch.Tensor              # (b, S, kv, hd)
    v: torch.Tensor


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int],
                k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(sq, bk) boolean mask of allowed attention edges."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    if k_valid is not None:
        mask &= k_valid[None, :]
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_k: int = 512) -> torch.Tensor:
    """q: (b, sq, h, hd); k, v: (b, sk, kv, hd) with h = kv * group.
    Returns (b, sq, h, hd) in q's dtype; the softmax runs in float32."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    block_k = min(block_k, sk)
    n_blocks = -(-sk // block_k)
    dev = q.device

    qg = (q.reshape(b, sq, kv, g, hd) * scale).float()
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, sq, hd), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        k_pos = j * block_k + torch.arange(block_k, device=dev)
        k_j = k[:, j * block_k:(j + 1) * block_k].float()
        v_j = v[:, j * block_k:(j + 1) * block_k].float()
        pad = block_k - k_j.shape[1]
        if pad:                    # the ragged last block, as JAX's zero pad
            k_j = torch.nn.functional.pad(k_j, (0, 0, 0, 0, 0, pad))
            v_j = torch.nn.functional.pad(v_j, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bqkgd,btkd->bkgqt", qg, k_j)
        mask = _block_mask(q_pos, k_pos, causal, window, k_valid=k_pos < sk)
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.clamp(m_new, min=-0.5e30)          # avoid inf-inf -> nan
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, v_j)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
