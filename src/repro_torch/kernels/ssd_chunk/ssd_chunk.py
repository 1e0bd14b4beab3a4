"""Wrapper of the CUDA Mamba2 SSD within-chunk kernel
(``csrc/ssd_chunk.cu``), the port of the Pallas kernel in
``repro/kernels/ssd_chunk/ssd_chunk.py:61``, and its
``torch.autograd.Function``.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the kernel, or the call raises. There is no fallback
from a failed build or launch. ``ssd_chunk.launches`` counts the kernel's
launches.

``SSDChunkFunction`` makes the kernel trainable: its forward is
``ssd_chunk``, its backward recomputes the plain version from the saved
inputs and back-propagates through it. JAX trains SSM layers through the
plain ``models/ssm.py::ssd_chunked`` (its Pallas kernel has no backward),
so a plain backward is the reference's own semantics. Its ``vmap`` rule
folds the mapped dimension into the batch rows of one launch; the decay
rates ``a`` then come one row a batch row, since the training round maps
over workers and every worker has its own ``A_log``.
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
                                     + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ssd_chunk_launch.restype = ctypes.c_int
    lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(xs, dt, a, B, C):
    if xs.dim() != 5 or dt.dim() != 4 or a.dim() not in (1, 2) \
            or B.dim() != 4:
        raise ValueError(f"want xs (b, nc, L, nh, hd), dt (b, nc, L, nh), "
                         f"a (nh,) or (b, nh), B and C (b, nc, L, ds); got "
                         f"{tuple(xs.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B.shape)}")
    b, nc, L, nh, hd = xs.shape
    ds = B.shape[-1]
    if (dt.shape != (b, nc, L, nh) or a.shape not in ((nh,), (b, nh))
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
    bfloat16; dt (b, nc, L, nh) and a (nh,) or (b, nh) in float32 (one row
    of decay rates for every batch row, or one a batch row). Returns (y_diag
    (b, nc, L, nh, hd), states (b, nc, nh, ds, hd), totals (b, nc, nh)),
    all float32."""
    devices = {t.device for t in (xs, dt, a, B, C)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "meta"):
        return ssd_chunk_ref(xs, dt, a, B, C)
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu, meta or cuda, not {dev}")
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
            0 if a.dim() == 1 else nh,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: error {err}")
    ssd_chunk.launches += 1
    return y, states, totals


ssd_chunk.launches = 0


def _rows(t: torch.Tensor, bdim, n: int) -> torch.Tensor:
    """(n, b, ...) with the mapped dim first, flattened to (n b, ...)."""
    t = t.expand(n, *t.shape) if bdim is None else t.movedim(bdim, 0)
    return t.flatten(0, 1).contiguous()


class SSDChunkFunction(torch.autograd.Function):
    """(xs, dt, a, B, C) -> (y_diag, states, totals) of ``ssd_chunk``,
    differentiable in every input. The backward runs ``ssd_chunk_ref`` on
    the saved inputs under autograd: the plain version's own gradient, as
    JAX differentiates its plain ``ssd_chunked``."""

    @staticmethod
    def forward(xs, dt, a, B, C):
        return ssd_chunk(xs, dt, a, B, C)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g_y, g_states, g_totals):
        # torch.func.vjp, not autograd.grad: the backward also runs under
        # torch.func transforms (grad of a vmapped loss)
        _, pullback = torch.func.vjp(ssd_chunk_ref, *ctx.saved_tensors)
        grads = pullback((g_y, g_states, g_totals))
        return tuple(g if n else None
                     for g, n in zip(grads, ctx.needs_input_grad))

    @staticmethod
    def vmap(info, in_dims, xs, dt, a, B, C):
        """One launch for the whole mapped batch: the mapped dimension n
        joins the batch rows (n b of them). A mapped ``a`` becomes the
        (n b, nh) rows of decay rates, each batch row its own; an
        unmapped (nh,) stays shared."""
        n = info.batch_size
        x_d, dt_d, a_d, b_d, c_d = in_dims
        xs_r, dt_r, B_r, C_r = (_rows(t, d, n) for t, d in
                                ((xs, x_d), (dt, dt_d), (B, b_d), (C, c_d)))
        rows = xs_r.shape[0] // n
        if a_d is None and a.dim() == 1:
            a_r = a
        else:
            a_n = a.expand(n, *a.shape) if a_d is None else a.movedim(a_d, 0)
            if a_n.dim() == 2:              # (n, nh): one row a mapped index
                a_n = a_n[:, None].expand(n, rows, a_n.shape[-1])
            a_r = a_n.flatten(0, 1).contiguous()
        outs = SSDChunkFunction.apply(xs_r, dt_r, a_r, B_r, C_r)
        return tuple(o.unflatten(0, (n, rows)) for o in outs), (0, 0, 0)
