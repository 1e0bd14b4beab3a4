"""Wrapper of the CUDA fused cross-entropy kernel (``csrc/fused_ce.cu``),
the port of the Pallas kernel in ``repro/kernels/fused_ce/fused_ce.py:67``,
and the ``torch.autograd.Function`` around it.

``fused_ce_fwd`` is the launch: a tensor on the CPU takes the plain
version (``ref.py``); a tensor on a CUDA device launches the kernel, or
the call raises. There is no fallback from a failed build or launch.
``fused_ce_fwd.launches`` counts the kernel's launches.

``FusedCEFunction`` runs ``fused_ce_fwd`` on both devices, so the CPU
tests exercise its ``setup_context``, its ``vmap`` rule and its backward.
Its ``vmap`` staticmethod moves the mapped dimension into the rows, so the
training round's loss, run under ``vmap`` over the workers, launches the
kernel once for all workers: (W, T, V) logits are W * T rows of one
launch. The backward is plain torch ops on the saved ``lse`` (the JAX
kernel has no backward kernel either):

    dlogits = (exp(logits - lse) - onehot(label)) * g

where a label outside ``[0, V)`` has no one-hot entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_ce.ref import fused_ce_fwd_ref


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("fused_ce").fused_ce_launch
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() < 1 or logits.shape[-1] < 1:
        raise ValueError(f"logits must be (..., V) with V >= 1; got "
                         f"{tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, not {logits.dtype}")
    if labels.shape != logits.shape[:-1]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits "
                         f"{tuple(logits.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, not {labels.dtype}")


def fused_ce_fwd(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V) float32; labels (...) int32/int64. Returns (nll,
    lse), each (...) float32. A label outside [0, V) gives nll = lse."""
    if logits.device != labels.device:
        raise ValueError(f"logits on {logits.device}, labels on "
                         f"{labels.device}")
    dev = logits.device
    if dev.type in ("cpu", "meta"):
        return fused_ce_fwd_ref(logits, labels)
    if dev.type != "cuda":
        raise ValueError(f"fused_ce runs on cpu, meta or cuda, not {dev}")
    _check(logits, labels)
    v = logits.shape[-1]
    x = logits.contiguous()
    y = labels.to(torch.int32).contiguous()
    t = x.numel() // v
    nll = torch.empty(labels.shape, dtype=torch.float32, device=dev)
    lse = torch.empty(labels.shape, dtype=torch.float32, device=dev)
    if t == 0:
        return nll, lse
    vec = 4 if v % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(dev):
        err = _launch_fn()(x.data_ptr(), y.data_ptr(), nll.data_ptr(),
                           lse.data_ptr(), t, v, vec,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce launch failed: error {err}")
    fused_ce_fwd.launches += 1
    return nll, lse


fused_ce_fwd.launches = 0


def _batched(t: torch.Tensor, bdim, n: int) -> torch.Tensor:
    return t.expand(n, *t.shape) if bdim is None else t.movedim(bdim, 0)


class FusedCEFunction(torch.autograd.Function):
    """(logits, labels) -> (nll, lse); ``lse`` is not differentiable, nor
    are the labels."""

    @staticmethod
    def forward(logits, labels):
        return fused_ce_fwd(logits, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels = inputs
        _, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(logits, labels, lse)

    @staticmethod
    def backward(ctx, g, _g_lse):
        logits, labels, lse = ctx.saved_tensors
        v = logits.shape[-1]
        p = torch.exp(logits.to(lse.dtype) - lse[..., None])
        hit = ((labels >= 0) & (labels < v)).to(p.dtype)
        p = p.scatter_add(-1, labels.long().clamp(0, v - 1)[..., None],
                          -hit[..., None])
        return (p * g[..., None]).to(logits.dtype), None

    @staticmethod
    def vmap(info, in_dims, logits, labels):
        """The mapped dimension becomes rows of one launch."""
        n = info.batch_size
        out = FusedCEFunction.apply(_batched(logits, in_dims[0], n),
                                    _batched(labels, in_dims[1], n))
        return out, (0, 0)
