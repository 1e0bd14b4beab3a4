"""GQA attention for prefill: chunked (flash-style) softmax over key blocks
with causal and sliding-window masking, and its q-blocked form for
sliding windows that skips the key blocks outside the window, the
counterparts of ``flash_attention``, ``flash_attention_windowed`` and
``_block_mask`` in ``repro/models/attention.py``; and the VLM's gated
layers' cross-attention over media embeddings (``cross_attention`` :239).

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
    s.param("wq", (d_model, n_heads, head_dim),
            ("embed", "heads", "head_dim"))
    s.param("wk", (d_model, n_kv_heads, head_dim),
            ("embed", "kv_heads", "head_dim"))
    s.param("wv", (d_model, n_kv_heads, head_dim),
            ("embed", "kv_heads", "head_dim"))
    s.param("wo", (n_heads, head_dim, d_model),
            ("heads", "head_dim", "embed"))


class KVCache(NamedTuple):
    k: torch.Tensor              # (b, S, kv, hd)
    v: torch.Tensor


def proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def merge_heads(att: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", att, wo)`` as one matrix product."""
    h, k, d = wo.shape
    return att.reshape(*att.shape[:-2], h * k) @ wo.reshape(h * k, d)


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


def flash_attention_windowed(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             block: int = 512) -> torch.Tensor:
    """Causal sliding-window attention by query blocks: query block i
    attends only to the keys [max(0, (i - wb) * block), (i + 1) * block),
    wb = ceil(window / block), so the work is O(s * (window + block))
    instead of O(s^2). Falls back to ``flash_attention`` when
    ``s <= block`` or ``window >= s``, as JAX's does. Shapes as
    ``flash_attention``."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if s <= block or window >= s:
        return flash_attention(q, k, v, causal=True, window=window,
                               block_k=block)
    blk = block
    nqb = -(-s // blk)
    padq = nqb * blk - s
    if padq:
        pad = (0, 0, 0, 0, 0, padq)
        q = torch.nn.functional.pad(q, pad)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    sp = nqb * blk
    wb = -(-window // blk)
    span = (wb + 1) * blk
    scale = hd ** -0.5
    dev = q.device

    outs = []
    for i in range(nqb):
        q_i = (q[:, i * blk:(i + 1) * blk].reshape(b, blk, kvh, g, hd)
               * scale).float()
        start = min(max(0, (i - wb) * blk), max(0, sp - span))
        kspan = k[:, start:start + min(span, sp)].float()
        vspan = v[:, start:start + min(span, sp)].float()
        q_pos = i * blk + torch.arange(blk, device=dev)
        k_pos = start + torch.arange(kspan.shape[1], device=dev)
        mask = _block_mask(q_pos, k_pos, True, window, k_valid=k_pos < s)
        sc = torch.einsum("bqkgd,btkd->bkgqt", q_i, kspan)
        sc = torch.where(mask[None, None, None], sc,
                         torch.full_like(sc, NEG_INF))
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqt,btkd->bkgqd", pr, vspan)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, blk, h, hd))
    return torch.cat(outs, dim=1)[:, :s].to(q.dtype)


# -- cross-attention (VLM) ----------------------------------------------------

def cross_attention_init(b: ParamBuilder, name: str, d_model: int,
                         n_heads: int, n_kv_heads: int, head_dim: int):
    attention_init(b, name, d_model, n_heads, n_kv_heads, head_dim)


def cross_kv(params, media: torch.Tensor, compute_dtype: torch.dtype):
    """The media's keys and values (b, M, kv, hd). JAX computes them as
    ``einsum(media, w.astype(compute_dtype))``, whose type is the
    promotion of the two: float32 media (what ``lm_batch`` makes) give
    float32 K/V beside bf16 queries. ``torch.matmul`` takes one dtype, so
    the weights are cast to the compute dtype and then to that promotion
    explicitly."""
    dt = torch.promote_types(media.dtype, compute_dtype)
    media = media.to(dt)
    return tuple(proj_heads(media, params[n].to(compute_dtype).to(dt))
                 for n in ("wk", "wv"))


def cross_attention(params, x: torch.Tensor, media: torch.Tensor, *,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """x (b, s, d) attends over media embeddings (b, M, d): no mask, no
    rope; (b, s, d) in x's dtype. JAX computes it in plain jnp outside any
    Pallas kernel, as here."""
    k, v = cross_kv(params, media, compute_dtype)
    q = proj_heads(x, params["wq"].to(compute_dtype))
    out = flash_attention(q, k, v, causal=False)
    return merge_heads(out, params["wo"].to(compute_dtype))
