"""Primitive layers: RMSNorm, rotary embeddings, gated MLP, embeddings.

Follows ``repro/models/layers.py`` exactly, not Hugging Face's Gemma 3:
plain ``scale`` RMSNorm (not ``1 + scale``), no ``sqrt(d)`` embedding
scale, half-split RoPE, SwiGLU.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models.param import ParamBuilder

# (x, scale, eps) -> y: the RMSNorm function a model call goes through
NormFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


# -- RMSNorm -------------------------------------------------------------------

def rmsnorm_init(b: ParamBuilder, name: str, dim: int):
    b.scope(name).param("scale", (dim,), ("embed",), init="ones")


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            norm: NormFn = rmsnorm_kernel) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in x's dtype, the reduction
    in float32. ``norm`` is the ``kernels.rmsnorm`` op (the CUDA kernel on
    a CUDA tensor, its plain version on the CPU, differentiable also under
    ``torch.func``); ``kernels.rmsnorm.rmsnorm_ref`` is the plain version
    that ``chip_smoke.py`` holds it to."""
    return norm(x, params["scale"], eps)


def add_rmsnorm(params, x: torch.Tensor, delta: Optional[torch.Tensor],
                eps: float = 1e-6, norm: NormFn = rmsnorm_kernel
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``s = x + delta`` and ``rmsnorm(s)``: returns
    (s, the norm of s). A ``norm`` that carries its fused form as
    ``norm.fused_add`` (the ``kernels.rmsnorm`` op: one launch) runs it;
    any other norm runs torch's add and then ``norm``, the plain version
    of the same function. ``delta=None`` (no residual pending, as before a
    model's first layer) is the plain norm of x."""
    if delta is None:
        return x, rmsnorm(params, x, eps, norm)
    fused = getattr(norm, "fused_add", None)
    if fused is not None:
        return fused(x, delta, params["scale"], eps)
    s = x + delta
    return s, rmsnorm(params, s, eps, norm)


# -- Rotary position embeddings --------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim/2,)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) for ``positions`` (..., seq), each (..., seq, 1, hd/2);
    a decode step computes them once for all its layers."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., :, None].float() * freqs       # (..., s, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# -- Gated (SwiGLU) MLP -----------------------------------------------------------

def mlp_init(b: ParamBuilder, name: str, d_model: int, d_ff: int):
    s = b.scope(name)
    s.param("w_gate", (d_model, d_ff), ("embed", "ffn"))
    s.param("w_up", (d_model, d_ff), ("embed", "ffn"))
    s.param("w_down", (d_ff, d_model), ("ffn", "embed"))


def mlp(params, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    g = x @ params["w_gate"].to(compute_dtype)
    u = x @ params["w_up"].to(compute_dtype)
    return (F.silu(g) * u) @ params["w_down"].to(compute_dtype)


# -- Embedding / LM head ------------------------------------------------------------

def embed_init(b: ParamBuilder, name: str, vocab: int, d_model: int,
               n_codebooks: int = 0):
    """``tok`` is (V, d), or (n_q, V, d) with ``n_codebooks`` (audio)."""
    s = b.scope(name)
    if n_codebooks > 0:
        s.param("tok", (n_codebooks, vocab, d_model), (None, "vocab", "embed"),
                scale=d_model ** -0.5)
    else:
        s.param("tok", (vocab, d_model), ("vocab", "embed"),
                scale=d_model ** -0.5)


def embed(params, tokens: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """tokens (b, s) -> (b, s, d), or (b, s, n_q) -> the sum of the n_q
    codebooks' rows. JAX sums them as a one-hot einsum in the compute
    dtype; here each row is gathered and cast to it, the n_q rows are
    summed in float32 and rounded once (the same values as casting the
    table first)."""
    tok = params["tok"]
    if tok.dim() == 3:           # audio: (n_q, V, d), tokens (..., n_q)
        codebook = torch.arange(tok.shape[0], device=tok.device)
        rows = tok[codebook, tokens.long()].to(compute_dtype)
        return rows.float().sum(dim=-2).to(compute_dtype)
    return tok[tokens.long()].to(compute_dtype)


def head_init(b: ParamBuilder, name: str, d_model: int, vocab: int,
              n_codebooks: int = 0):
    """``w`` is (d, V), or (n_q, d, V) with ``n_codebooks`` (audio)."""
    s = b.scope(name)
    if n_codebooks > 0:
        s.param("w", (n_codebooks, d_model, vocab), (None, "embed", "vocab"))
    else:
        s.param("w", (d_model, vocab), ("embed", "vocab"))


def _softcap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def head(params, x: torch.Tensor, compute_dtype: torch.dtype,
         softcap: float = 0.0) -> torch.Tensor:
    """x (..., d) -> logits (..., V), or (..., n_q, V) for a codebook head
    (audio)."""
    w = params["w"].to(compute_dtype)
    if w.dim() == 3:
        return _softcap(torch.einsum("...d,qdv->...qv", x, w), softcap)
    return _softcap(x @ w, softcap)


def tied_head(embed_params, x: torch.Tensor, compute_dtype: torch.dtype,
              softcap: float = 0.0) -> torch.Tensor:
    return _softcap(x @ embed_params["tok"].to(compute_dtype).T, softcap)
