"""Wrapper of the CUDA Mamba2 SSD within-chunk kernel
(``csrc/ssd_chunk.cu``), the port of the Pallas kernel in
``repro/kernels/ssd_chunk/ssd_chunk.py:61``.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the kernel, or the call raises. There is no fallback
from a failed build or launch. ``ssd_chunk.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_L = (16, 32, 64)
_SUPPORTED_HD = (32, 64, 128)
_MAX_SMEM = 232448              # dynamic shared memory a Hopper block may use


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("ssd_chunk")
    lib.ssd_chunk_launch.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ssd_chunk_launch.restype = ctypes.c_int
    lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(xs, dt, a, B, C):
    if xs.dim() != 5 or dt.dim() != 4 or a.dim() != 1 or B.dim() != 4:
        raise ValueError(f"want xs (b, nc, L, nh, hd), dt (b, nc, L, nh), "
                         f"a (nh,), B and C (b, nc, L, ds); got "
                         f"{tuple(xs.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B.shape)}")
    b, nc, L, nh, hd = xs.shape
    ds = B.shape[-1]
    if (dt.shape != (b, nc, L, nh) or a.shape != (nh,)
            or B.shape != (b, nc, L, ds) or C.shape != B.shape):
        raise ValueError("xs, dt, a, B and C do not agree in shape")
    if xs.dtype not in _X_CODE or B.dtype != xs.dtype or C.dtype != xs.dtype:
        raise TypeError(f"xs, B and C must share float32 or bfloat16; got "
                        f"{xs.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32; got {dt.dtype}, "
                        f"{a.dtype}")
    if L not in _SUPPORTED_L or hd not in _SUPPORTED_HD or ds % 4:
        raise ValueError(f"unsupported chunk {L}, head_dim {hd} or d_state "
                         f"{ds}: the kernel takes L in {_SUPPORTED_L}, hd in "
                         f"{_SUPPORTED_HD} and ds a multiple of 4")
    if b * nc > 65535:
        raise ValueError(f"b * nc = {b * nc} exceeds the grid's 65535")
    for name, t in (("xs", xs), ("dt", dt), ("a", a), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_chunk(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xs (b, nc, L, nh, hd) and B, C (b, nc, L, ds) in float32 or
    bfloat16; dt (b, nc, L, nh) and a (nh,) in float32. Returns (y_diag
    (b, nc, L, nh, hd), states (b, nc, nh, ds, hd), totals (b, nc, nh)),
    all float32."""
    devices = {t.device for t in (xs, dt, a, B, C)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return ssd_chunk_ref(xs, dt, a, B, C)
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda, not {dev}")
    _check(xs, dt, a, B, C)
    b, nc, L, nh, hd = xs.shape
    ds = B.shape[-1]
    lib = _lib()
    smem = lib.ssd_chunk_smem_bytes(L, ds, hd, _X_CODE[xs.dtype])
    if smem > _MAX_SMEM:
        raise ValueError(f"d_state {ds} needs {smem} bytes of shared memory "
                         f"per block; the card gives {_MAX_SMEM}")
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, nc, L, nh, hd), **f32)
    states = torch.empty((b, nc, nh, ds, hd), **f32)
    totals = torch.empty((b, nc, nh), **f32)
    with torch.cuda.device(dev):
        err = lib.ssd_chunk_launch(
            xs.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), states.data_ptr(), totals.data_ptr(),
            _X_CODE[xs.dtype], b, nc, L, nh, hd, ds,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: error {err}")
    ssd_chunk.launches += 1
    return y, states, totals


ssd_chunk.launches = 0
