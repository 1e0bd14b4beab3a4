"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), the port of
the Pallas kernel in ``repro/kernels/rmsnorm/rmsnorm.py:29``, and the
``torch.autograd.Function`` around it.

``rmsnorm_fwd`` is the launch: a tensor on the CPU takes the plain version
(``ref.py``); a tensor on a CUDA device launches the kernel, or the call
raises. There is no fallback from a failed build or launch.
``rmsnorm_fwd.launches`` counts the kernel's launches.

``RMSNormFunction`` runs ``rmsnorm_fwd`` on both devices, so the CPU tests
exercise its ``setup_context``, its ``vmap`` rule and its backward. It is
written in the ``torch.func`` style (a ``forward`` without ``ctx``, a
``setup_context``), because the training round runs the loss under
``vmap`` over the workers and a ctypes launch cannot see a batched
tensor: the ``vmap`` staticmethod moves the worker dimension into the rows
and launches the kernel once for all workers, with one scale row per
worker when the scale is batched. The backward is plain torch ops on the
saved ``rstd`` (vmappable, so ``torch.func.grad`` works too; the JAX
kernel has no backward kernel either):

    x_hat = x * rstd,  gs = g * scale
    dx     = rstd * (gs - x_hat * mean(gs * x_hat, -1))
    dscale = sum over each group's rows of g * x_hat

``add_rmsnorm_fwd`` is the same launch with the residual add fused in
(``s = x + delta``, then the norm of ``s``; it counts in
``rmsnorm_fwd.launches``), and ``AddRMSNormFunction`` its Function, with
the same ``vmap`` rule and backward (the cotangent of ``s`` plus the
norm's ``dx``, to both x and delta).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import (acc, add_rmsnorm_fwd_ref,
                                             group_scale, rmsnorm_fwd_ref)

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, scale: torch.Tensor,
           delta: Optional[torch.Tensor] = None) -> None:
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be (..., d) with d >= 1; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _X_CODE:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if delta is not None and (delta.shape != x.shape
                              or delta.dtype != x.dtype):
        raise ValueError(f"delta {tuple(delta.shape)} {delta.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    if scale.dim() == 1:
        if scale.shape[0] != d:
            raise ValueError(f"scale {tuple(scale.shape)} does not match "
                             f"d = {d}")
    elif scale.dim() == 2:
        if scale.shape[1] != d or x.dim() < 2 \
                or x.shape[0] != scale.shape[0]:
            raise ValueError(f"a (G, d) scale {tuple(scale.shape)} needs x "
                             f"(G, ..., d); got {tuple(x.shape)}")
    else:
        raise ValueError(f"scale must be (d,) or (G, d); got "
                         f"{tuple(scale.shape)}")


def vector_width(d: int, *tensors: torch.Tensor) -> int:
    """16-byte loads (4 float32 or 8 bfloat16 values) when d is a multiple
    of that count and every base pointer is 16-byte aligned, else 1."""
    vec = 16 // tensors[0].element_size()
    if d % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def _device_of(**tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(", ".join(f"{name} on {t.device}"
                                   for name, t in tensors.items()))
    dev = devices.pop()
    if dev.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"rmsnorm runs on cpu, meta or cuda, not {dev}")
    return dev


def _launch(x: torch.Tensor, delta: Optional[torch.Tensor],
            scale: torch.Tensor, eps: float):
    """One launch on CUDA tensors: (s or None, y, rstd)."""
    _check(x, scale, delta)
    dev = x.device
    x = x.contiguous()
    delta = None if delta is None else delta.contiguous()
    sc = scale.to(torch.float32).contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    groups = 1 if scale.dim() == 1 else scale.shape[0]
    out = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    if rows == 0:
        return s, out, rstd
    rows_ptrs = [t for t in (x, delta, s, out) if t is not None]
    with torch.cuda.device(dev):
        err = _launch_fn()(
            x.data_ptr(), None if delta is None else delta.data_ptr(),
            sc.data_ptr(), None if s is None else s.data_ptr(),
            out.data_ptr(), rstd.data_ptr(), _X_CODE[x.dtype], rows, d,
            rows // groups, float(eps), vector_width(d, *rows_ptrs, sc),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: error {err}")
    rmsnorm_fwd.launches += 1
    if delta is not None:
        add_rmsnorm_fwd.launches += 1
    return s, out, rstd


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d) float32/bfloat16; scale: (d,), or (G, d) with x
    (G, ..., d) (group g's rows take scale[g]). Returns (y in x's dtype,
    rstd (...,) float32)."""
    if _device_of(x=x, scale=scale).type in ("cpu", "meta"):
        return rmsnorm_fwd_ref(x, scale, eps)
    _, y, rstd = _launch(x, None, scale, eps)
    return y, rstd


rmsnorm_fwd.launches = 0


def add_rmsnorm_fwd(x: torch.Tensor, delta: torch.Tensor,
                    scale: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The residual add and the norm in one launch: x, delta (..., d) of
    one dtype; scale as ``rmsnorm_fwd``. Returns (s = x + delta, rounded
    once to x's dtype as torch's add; y = the norm of s; rstd). The
    launch counts in ``rmsnorm_fwd.launches`` (every launch of the kernel)
    and in ``add_rmsnorm_fwd.launches`` (the fused ones)."""
    if _device_of(x=x, delta=delta, scale=scale).type in ("cpu", "meta"):
        return add_rmsnorm_fwd_ref(x, delta, scale, eps)
    return _launch(x, delta, scale, eps)


add_rmsnorm_fwd.launches = 0


def _batched(t: torch.Tensor, bdim, n: int) -> torch.Tensor:
    return t.expand(n, *t.shape) if bdim is None else t.movedim(bdim, 0)


def _vmap_rows(info, row_args, scale, s_bdim, apply):
    """The ``vmap`` rule of both Functions: the mapped dimension becomes
    rows of one launch. ``row_args`` are (tensor, bdim) pairs of (..., d)
    inputs. A mapped scale becomes the (G, d) scale, one row per mapped
    index; a scale that was already (G, d) is flattened with the inputs'
    leading dims. Returns ``apply``'s outputs with the mapped dim at 0."""
    n = info.batch_size
    xs = [_batched(t, b, n) for t, b in row_args]
    if s_bdim is None and scale.dim() == 1:
        return apply(*xs, scale)
    s = _batched(scale, s_bdim, n)
    if s.dim() == 2:
        return apply(*xs, s)
    outs = apply(*[t.flatten(0, 1) for t in xs], s.flatten(0, 1))
    return tuple(o.unflatten(0, (n, -1)) for o in outs)


def _norm_grads(x, scale, rstd, g):
    """(dx in the accumulation type, dscale) of y = rmsnorm(x, scale) for
    the output cotangent g."""
    r = rstd[..., None]
    x_hat = acc(x) * r
    gf = acc(g)
    gs = gf * acc(group_scale(scale, x))
    dx = r * (gs - x_hat * (gs * x_hat).mean(dim=-1, keepdim=True))
    gx = gf * x_hat
    if scale.dim() == 1:
        dscale = gx.reshape(-1, x.shape[-1]).sum(dim=0)
    else:
        dscale = gx.reshape(scale.shape[0], -1, x.shape[-1]).sum(dim=1)
    return dx, dscale.to(scale.dtype)


class RMSNormFunction(torch.autograd.Function):
    """(x, scale, eps) -> (y, rstd); ``rstd`` is not differentiable."""

    @staticmethod
    def forward(x, scale, eps):
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _ = inputs
        _, rstd = output
        ctx.mark_non_differentiable(rstd)
        ctx.save_for_backward(x, scale, rstd)

    @staticmethod
    def backward(ctx, g, _g_rstd):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = _norm_grads(x, scale, rstd, g)
        return dx.to(x.dtype), dscale, None

    @staticmethod
    def vmap(info, in_dims, x, scale, eps):
        x_bdim, s_bdim, _ = in_dims
        return _vmap_rows(info, [(x, x_bdim)], scale, s_bdim,
                          lambda a, s: RMSNormFunction.apply(a, s, eps)
                          ), (0, 0)


class AddRMSNormFunction(torch.autograd.Function):
    """(x, delta, scale, eps) -> (s = x + delta, y = rmsnorm(s), rstd), one
    launch; ``rstd`` is not differentiable. The backward is PyTorch ops on
    the saved s and rstd: the cotangent reaching s is the incoming g_s
    plus the norm's dx (each in s's dtype, as autograd would add them for
    ``x + delta`` followed by the norm), and it goes to x and to delta."""

    @staticmethod
    def forward(x, delta, scale, eps):
        return add_rmsnorm_fwd(x, delta, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, scale, _ = inputs
        s, _, rstd = output
        ctx.mark_non_differentiable(rstd)
        ctx.save_for_backward(s, scale, rstd)

    @staticmethod
    def backward(ctx, g_s, g_y, _g_rstd):
        s, scale, rstd = ctx.saved_tensors
        dx, dscale = _norm_grads(s, scale, rstd, g_y)
        ds = dx.to(s.dtype)
        if g_s is not None:
            ds = g_s + ds
        return ds, ds, dscale, None

    @staticmethod
    def vmap(info, in_dims, x, delta, scale, eps):
        x_bdim, d_bdim, s_bdim, _ = in_dims
        return _vmap_rows(info, [(x, x_bdim), (delta, d_bdim)], scale,
                          s_bdim,
                          lambda a, b, s: AddRMSNormFunction.apply(a, b, s,
                                                                   eps)
                          ), (0, 0, 0)
