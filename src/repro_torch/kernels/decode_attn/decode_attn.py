"""Wrapper of the CUDA decode-attention kernel over a contiguous cache
(``csrc/decode_attn.cu``), the port of the Pallas kernel in
``repro/kernels/decode_attn/decode_attn.py:78``.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the kernel, or the call raises. There is no fallback
from a failed build or launch. ``decode_attn.launches`` counts the
kernel's launches: one device kernel per call, which merges its splits itself
(the splits of a row are one thread block cluster) and allocates no
scratch. q and the cache take any pair of float32 and bfloat16,
1 <= g <= 8 and any head_dim that is a multiple of 16 up to 256.

``cache_len`` is one length for the whole batch. A Python int goes to the
kernel as an argument, so the caller's host loop never reads the device;
a 0-d int32 tensor on the card is read by the kernel from device memory.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.paged import check_shapes
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPLITS = 16                # a thread block cluster: the row's splits
_TARGET_BLOCKS = 264            # two CUDA blocks for each of the 132 SMs
_MIN_PER_SPLIT = 8              # positions: two for each of a block's warps


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("decode_attn").decode_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, kv: int, S: int):
    """(positions per split, splits): enough CUDA blocks to cover the
    card's SMs when b * kv is small, at most ``_MAX_SPLITS`` splits (one
    thread block cluster a row), splits covering S."""
    want = max(1, min(_MAX_SPLITS, math.ceil(_TARGET_BLOCKS / (b * kv))))
    per = max(_MIN_PER_SPLIT, math.ceil(S / want))
    return per, math.ceil(S / per)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (b, kv, g, hd) and k, v (b, S, kv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, kv, g, hd = q.shape
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError("k and v differ in shape or dtype")
    if k.shape[0] != b or k.shape[2] != kv or k.shape[3] != hd:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    check_shapes(q.dtype, k.dtype, g, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:           # the kernel's bulk copies
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cache_len: Union[int, torch.Tensor], *,
                window: Optional[int] = None) -> torch.Tensor:
    """q: (b, kv, g, hd); k, v: (b, S, kv, hd); ``cache_len``: the number
    of valid positions, an int or a 0-d int32 tensor on q's device.
    Returns (b, kv, g, hd) in q's dtype."""
    devices = {t.device for t in (q, k, v)}
    if isinstance(cache_len, torch.Tensor):
        devices.add(cache_len.device)
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "meta"):
        return decode_attn_ref(q, k, v, cache_len, window=window)
    if dev.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu, meta or cuda, not {dev}")
    _check(q, k, v)
    if isinstance(cache_len, torch.Tensor):
        if cache_len.shape != () or cache_len.dtype != torch.int32:
            raise ValueError("a tensor cache_len must be a 0-d int32 tensor")
        len_ptr, len_host = cache_len.data_ptr(), 0
    else:
        len_ptr, len_host = None, int(cache_len)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, kv, g, hd = q.shape
    S = k.shape[1]
    per, n_split = split_plan(b, kv, S)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _launch_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr,
            out.data_ptr(), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], b, kv,
            g, hd, S, per, n_split, len_host, 0 if window is None else window,
            hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: error {err}")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
