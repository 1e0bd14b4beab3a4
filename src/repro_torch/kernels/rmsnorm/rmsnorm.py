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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import acc, group_scale, rmsnorm_fwd_ref

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be (..., d) with d >= 1; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _X_CODE:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
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


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d) float32/bfloat16; scale: (d,), or (G, d) with x
    (G, ..., d) (group g's rows take scale[g]). Returns (y in x's dtype,
    rstd (...,) float32)."""
    if x.device != scale.device:
        raise ValueError(f"x on {x.device}, scale on {scale.device}")
    dev = x.device
    if dev.type == "cpu":
        return rmsnorm_fwd_ref(x, scale, eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {dev}")
    _check(x, scale)
    x = x.contiguous()
    s = scale.to(torch.float32).contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    groups = 1 if scale.dim() == 1 else scale.shape[0]
    out = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    if rows == 0:
        return out, rstd
    with torch.cuda.device(dev):
        err = _launch_fn()(
            x.data_ptr(), s.data_ptr(), out.data_ptr(), rstd.data_ptr(),
            _X_CODE[x.dtype], rows, d, rows // groups, float(eps),
            vector_width(d, x, out, s),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: error {err}")
    rmsnorm_fwd.launches += 1
    return out, rstd


rmsnorm_fwd.launches = 0


def _batched(t: torch.Tensor, bdim, n: int) -> torch.Tensor:
    return t.expand(n, *t.shape) if bdim is None else t.movedim(bdim, 0)


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
        return dx.to(x.dtype), dscale.to(scale.dtype), None

    @staticmethod
    def vmap(info, in_dims, x, scale, eps):
        """The mapped dimension becomes rows of one launch. A mapped scale
        becomes the (G, d) scale, one row per mapped index; a scale that
        was already (G, d) is flattened with x's leading dims."""
        x_bdim, s_bdim, _ = in_dims
        n = info.batch_size
        x = _batched(x, x_bdim, n)
        if s_bdim is None and scale.dim() == 1:
            y, rstd = RMSNormFunction.apply(x, scale, eps)
            return (y, rstd), (0, 0)
        s = _batched(scale, s_bdim, n)
        if s.dim() == 2:
            y, rstd = RMSNormFunction.apply(x, s, eps)
            return (y, rstd), (0, 0)
        y, rstd = RMSNormFunction.apply(x.flatten(0, 1), s.flatten(0, 1), eps)
        return (y.unflatten(0, (n, -1)), rstd.unflatten(0, (n, -1))), (0, 0)
