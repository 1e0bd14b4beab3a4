"""Wrapper of the CUDA fused aggregation kernel (``csrc/wagg_fused.cu``),
the port of the Pallas kernel in ``repro/kernels/wagg/wagg.py:88``.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the kernel, or the call raises. There is no fallback
from a failed build or launch. ``wagg_fused.launches`` counts the
kernel's launches, ``wagg_fused.masked_launches`` those with an Alg. 4
mask.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wagg.ref import wagg_fused_ref

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("wagg_fused").wagg_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, theta, payload, active):
    if x.dim() != 2:
        raise ValueError(f"x must be (p, N); got {tuple(x.shape)}")
    p, n = x.shape
    if p < 1 or n < 1:
        raise ValueError(f"x must have p >= 1 rows and N >= 1 columns; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _X_CODE:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if theta.shape != (p,) or theta.dtype != torch.float32:
        raise ValueError(f"theta must be ({p},) float32")
    if payload is not None:
        if payload.shape != x.shape:
            raise ValueError(f"payload {tuple(payload.shape)} does not match "
                             f"x {tuple(x.shape)}")
        if payload.dtype not in _Q_CODE:
            raise TypeError(f"payload must be float32, bfloat16 or int8, not "
                            f"{payload.dtype}")
    if active is not None and (active.shape != (p,)
                               or active.dtype != torch.float32):
        raise ValueError(f"active must be ({p},) float32")
    for name, t in (("x", x), ("theta", theta), ("payload", payload),
                    ("active", active)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def vector_width(n: int, *tensors: torch.Tensor) -> int:
    """4 columns per thread when every row starts 16-byte aligned (N a
    multiple of 4 and the base pointers aligned), else 1."""
    if n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 4
    return 1


def wagg_fused(x: torch.Tensor, theta: torch.Tensor, beta: float,
               payload: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (p, N) float32/bfloat16; theta: (p,) effective weights (a
    quantizing codec's scale folded in); payload: (p, N) float32/bfloat16/
    int8 or None (the payload is x); active: (p,) float32 0/1 or None (the
    caller casts a mask once for all its leaves). Returns (p, N) in x's
    dtype."""
    tensors = [t for t in (x, theta, payload, active) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "meta"):
        return wagg_fused_ref(x, theta, beta, payload=payload, active=active)
    if dev.type != "cuda":
        raise ValueError(f"wagg_fused runs on cpu, meta or cuda, not {dev}")
    theta = theta.to(torch.float32)
    _check(x, theta, payload, active)
    p, n = x.shape
    q = x if payload is None else payload
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = _launch_fn()(
            x.data_ptr(), q.data_ptr(), theta.data_ptr(),
            None if active is None else active.data_ptr(), out.data_ptr(),
            _X_CODE[x.dtype], _Q_CODE[q.dtype], p, n,
            vector_width(n, x, q, out), 1.0 - beta, beta,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wagg_fused launch failed: error {err}")
    wagg_fused.launches += 1
    wagg_fused.masked_launches += active is not None
    return out


wagg_fused.launches = 0
wagg_fused.masked_launches = 0
