"""Mamba2 mixer, SSD (state-space duality) chunked algorithm
[arXiv:2405.21060]: the counterpart of ``repro/models/ssm.py``.

Prefill runs the chunked form: quadratic attention-like blocks within
chunks of length L plus a linear recurrence over the chunk states. The
within-chunk blocks go through ``kernels.ssd_chunk`` (the CUDA kernel on a
CUDA tensor, its plain version on the CPU) by default; ``ssd_chunked`` is
the plain whole forward that ``chip_smoke.py`` holds it to, and the prefill
functions take it as their ``ssd`` argument. Decode carries an O(1)
recurrent state. ``ssd_reference`` is the per-step recurrence the tests
use as an oracle.

Layouts are JAX's: ``in_proj`` is (d, k) and applied as ``x @ w``,
``conv_w`` is (width, channels) and the causal convolution is JAX's
shifted sum in the compute dtype. (``F.conv1d`` would be one call, but a
float32 convolution on the card goes through cuDNN in TF32 by default.)
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_chunk import ssd_chunked_kernel
from repro_torch.models.param import ParamBuilder


class SSMState(NamedTuple):
    """Decode-time recurrent state."""
    s: torch.Tensor             # (b, nh, ds, hd)
    conv: torch.Tensor          # (b, conv_width - 1, di + 2 ds)


def ssm_init(b: ParamBuilder, name: str, d_model: int, cfg: SSMConfig):
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    ds = cfg.d_state
    s = b.scope(name)
    s.param("in_proj", (d_model, 2 * di + 2 * ds + nh), ("embed", "ssm_heads"))
    s.param("conv_w", (cfg.conv_width, di + 2 * ds), ("conv", "ssm_heads"))
    s.param("conv_b", (di + 2 * ds,), ("ssm_heads",), init="zeros")
    s.param("A_log", (nh,), ("ssm_heads",), init="uniform", scale=1.0)
    s.param("D", (nh,), ("ssm_heads",), init="ones")
    s.param("dt_bias", (nh,), ("ssm_heads",), init="zeros")
    s.param("norm_scale", (di,), ("ssm_heads",), init="ones")
    s.param("out_proj", (di, d_model), ("ssm_heads", "embed"))


def _split_proj(proj: torch.Tensor, di: int, ds: int, nh: int):
    z = proj[..., :di]
    xBC = proj[..., di:2 * di + 2 * ds]
    dt = proj[..., 2 * di + 2 * ds:]
    assert dt.shape[-1] == nh
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d as JAX's shifted sum. xBC: (b, s, ch);
    w: (width, ch); history: (b, width - 1, ch) or None (zeros)."""
    width = w.shape[0]
    if history is None:
        pad = torch.zeros((xBC.shape[0], width - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = history.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                  # (b, s + w - 1, ch)
    s = xBC.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + bias)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp(x, min=0)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale.float()


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in plain torch, as ``repro/models/ssm.py:70``.

    xs: (b, s, nh, hd); dt: (b, s, nh); a: (nh,) negative; B, C:
    (b, s, ds). Returns (y (b, s, nh, hd), final_state (b, nh, ds, hd)),
    float32."""
    b, s, nh, hd = xs.shape
    ds = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xs = xs.reshape(b, nc, chunk, nh, hd).float()
    dt = dt.reshape(b, nc, chunk, nh).float()
    B = B.reshape(b, nc, chunk, ds).float()
    C = C.reshape(b, nc, chunk, ds).float()

    cum = torch.cumsum(dt * a.float(), dim=2)               # (b, nc, L, nh)
    total = cum[:, :, -1]                                   # (b, nc, nh)

    # within-chunk (diagonal blocks)
    cb = torch.einsum("bnls,bnms->bnlm", C, B)              # (b, nc, L, L)
    dmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b, nc, L, L, nh)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xs.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], dmat,
                                  torch.full_like(dmat, -float("inf"))))
    att = decay * cb[..., None] * dt[:, :, None, :, :]
    y_diag = torch.einsum("bnlmh,bnmhd->bnlhd", att, xs)

    # chunk end-states
    decay_to_end = torch.exp(total[:, :, None, :] - cum)    # (b, nc, L, nh)
    states = torch.einsum("bnlh,bnls,bnlhd->bnhsd", decay_to_end * dt, B, xs)

    # inter-chunk recurrence
    prev = (torch.zeros((b, nh, ds, hd), dtype=torch.float32,
                        device=xs.device)
            if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = torch.exp(total[:, c])[:, :, None, None] * prev + states[:, c]
    prevs = torch.stack(prevs, dim=1)                       # (b, nc, nh, ds, hd)

    # off-diagonal: contribution of previous chunks' state
    y_off = torch.einsum("bnls,bnhsd,bnlh->bnlhd", C, prevs, torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, nh, hd), prev


def ssd_reference(xs, dt, a, B, C, init_state=None):
    """Naive per-step recurrence (oracle), as ``repro/models/ssm.py:125``."""
    b, s, nh, hd = xs.shape
    ds = B.shape[-1]
    st = (torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=xs.device)
          if init_state is None else init_state.float())
    xs, dt, B, C = (t.float() for t in (xs, dt, B, C))
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a)                        # (b, nh)
        st = da[:, :, None, None] * st + torch.einsum(
            "bh,bs,bhd->bhsd", dt[:, t], B[:, t], xs[:, t])
        ys.append(torch.einsum("bs,bhsd->bhd", C[:, t], st))
    return torch.stack(ys, dim=1), st


SSDFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def ssm_prefill(params, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                compute_dtype: torch.dtype, ssd: SSDFn = ssd_chunked_kernel
                ) -> Tuple[torch.Tensor, SSMState]:
    """The prefill form of the mixer over whole prompts x (b, s, d):
    (y (b, s, d) in x's dtype, the state after the last token). The prompt
    is padded to a chunk multiple with dt = 0 after the softplus (decay 1,
    contribution 0). This is the SSM branch of JAX's ``prefill``
    (``repro/models/transformer.py:388``); ``ssm_layer`` without a state
    returns its first half."""
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    ds = cfg.d_state
    b, s, _ = x.shape
    proj = x @ params["in_proj"].to(compute_dtype)
    z, xBC, dt_raw = _split_proj(proj, di, ds, nh)
    xBC_c = _causal_conv(xBC, params["conv_w"].to(compute_dtype),
                         params["conv_b"].to(compute_dtype))
    xin, B, C = xBC_c[..., :di], xBC_c[..., di:di + ds], xBC_c[..., di + ds:]
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())                # (nh,) < 0
    xs = xin.reshape(b, s, nh, cfg.head_dim)
    pad = (-s) % cfg.chunk_size
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        B_p = F.pad(B, (0, 0, 0, pad))
        C_p = F.pad(C, (0, 0, 0, pad))
    else:
        xs_p, dt_p, B_p, C_p = xs, dt, B, C
    y, final = ssd(xs_p, dt_p, a, B_p, C_p, cfg.chunk_size)
    y = y[:, :s] + params["D"].float()[:, None] * xs.float()
    out = _gated_norm(y.reshape(b, s, di), z, params["norm_scale"])
    y_out = (out.to(compute_dtype)
             @ params["out_proj"].to(compute_dtype)).to(x.dtype)
    w = cfg.conv_width
    conv_hist = torch.cat(
        [torch.zeros((b, max(0, w - 1 - s), di + 2 * ds), dtype=torch.float32,
                     device=x.device),
         xBC[:, -(w - 1):].float()], dim=1)
    return y_out, SSMState(final.float(), conv_hist)


def ssm_layer(params, x: torch.Tensor, cfg: SSMConfig, d_model: int,
              compute_dtype: torch.dtype, state: Optional[SSMState] = None,
              ssd: SSDFn = ssd_chunked_kernel
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full Mamba2 mixer, as ``repro/models/ssm.py:147``. x: (b, s, d).
    Without ``state``: the prefill form, (y, None). With ``state``: one
    decode step (s == 1), (y, the new state)."""
    if state is None:
        return ssm_prefill(params, x, cfg, d_model, compute_dtype, ssd)[0], None
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    ds = cfg.d_state
    b = x.shape[0]
    proj = x @ params["in_proj"].to(compute_dtype)
    z, xBC, dt_raw = _split_proj(proj, di, ds, nh)
    a = -torch.exp(params["A_log"].float())
    D = params["D"].float()
    hist = state.conv
    xBC_t = _causal_conv(xBC, params["conv_w"].to(compute_dtype),
                         params["conv_b"].to(compute_dtype), history=hist)
    new_conv = torch.cat([hist[:, 1:], xBC.to(hist.dtype)], dim=1)
    xin, B, C = xBC_t[..., :di], xBC_t[..., di:di + ds], xBC_t[..., di + ds:]
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())
    xs = xin.reshape(b, nh, cfg.head_dim).float()
    dt1 = dt[:, 0]                                          # (b, nh)
    b1 = B[:, 0].float()
    c1 = C[:, 0].float()
    da = torch.exp(dt1 * a)
    s_new = da[:, :, None, None] * state.s.float() + torch.einsum(
        "bh,bs,bhd->bhsd", dt1, b1, xs)
    y = torch.einsum("bs,bhsd->bhd", c1, s_new) + D[:, None] * xs
    out = _gated_norm(y.reshape(b, 1, di), z, params["norm_scale"])
    y_out = out.to(compute_dtype) @ params["out_proj"].to(compute_dtype)
    return y_out.to(x.dtype), SSMState(s_new.to(state.s.dtype), new_conv)


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig,
                   dtype=torch.float32, device=None) -> SSMState:
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    return SSMState(
        s=torch.zeros((batch, nh, cfg.d_state, cfg.head_dim), dtype=dtype,
                      device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, di + 2 * cfg.d_state),
                         dtype=dtype, device=device))
