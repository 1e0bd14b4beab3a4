"""Wrapper of the CUDA paged decode-attention kernel
(``csrc/paged_decode_attn.cu``), the port of the Pallas kernel in
``repro/kernels/decode_attn/paged.py:92``.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the kernel, or the call raises. There is no fallback
from a failed build or launch. ``paged_decode_attn.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.ref import check_ring, paged_decode_attn_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_DTYPES = {(torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.bfloat16),
                     (torch.float32, torch.float32)}
_SUPPORTED_G = (1, 2, 4, 8)
_SUPPORTED_HD = (32, 64, 128, 256)
_MAX_SPLITS = 64
_TARGET_BLOCKS = 264            # two CUDA blocks for each of the 132 SMs


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("paged_decode_attn").paged_decode_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, kv: int, n_blk: int):
    """(table blocks per split, splits): enough CUDA blocks to cover the
    card's SMs when b * kv is small, at most ``_MAX_SPLITS`` splits."""
    want = max(1, min(_MAX_SPLITS, math.ceil(_TARGET_BLOCKS / (b * kv))))
    per = math.ceil(n_blk / want)
    return per, math.ceil(n_blk / per)


def _check(q, k_pool, v_pool, block_table, index):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q must be (b, kv, g, hd) and pools "
                         f"(n_pool, bs, kv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}")
    b, kv, g, hd = q.shape
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError("k_pool and v_pool differ in shape or dtype")
    if k_pool.shape[2] != kv or k_pool.shape[3] != hd:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (block_table.dim() != 2 or block_table.shape[0] != b
            or block_table.dtype != torch.int32):
        raise ValueError(f"block_table must be ({b}, n_blk) int32")
    if index.shape != (b,) or index.dtype != torch.int32:
        raise ValueError(f"index must be ({b},) int32")
    if (q.dtype, k_pool.dtype) not in _SUPPORTED_DTYPES:
        raise TypeError(f"unsupported (q, pool) dtypes "
                        f"({q.dtype}, {k_pool.dtype})")
    if g not in _SUPPORTED_G or hd not in _SUPPORTED_HD:
        raise ValueError(f"unsupported group size {g} or head_dim {hd}: the "
                         f"kernel takes g in {_SUPPORTED_G}, hd in "
                         f"{_SUPPORTED_HD}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("index", index)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:           # the kernel's vector loads
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attn(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_table: torch.Tensor,
                      index: torch.Tensor, *, ring: Optional[int] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (b, kv, g, hd); pools: (n_pool, bs, kv, hd); block_table:
    (b, n_blk) int32 physical block ids, each < n_pool; index: (b,) int32
    position of each request's newest token. Returns (b, kv, g, hd) in
    q's dtype."""
    devices = {t.device for t in (q, k_pool, v_pool, block_table, index)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return paged_decode_attn_ref(q, k_pool, v_pool, block_table, index,
                                     ring=ring, window=window)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attn runs on cpu or cuda, not {dev}")
    _check(q, k_pool, v_pool, block_table, index)
    b, kv, g, hd = q.shape
    bs = k_pool.shape[1]
    n_blk = block_table.shape[1]
    check_ring(ring, n_blk, bs)
    per, n_split = split_plan(b, kv, n_blk)
    out = torch.empty_like(q)
    part_m = torch.empty(b * kv * n_split * g, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b * kv * n_split * g * hd, dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), index.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], b, kv, g, hd, bs,
            n_blk, per, n_split, 0 if ring is None else ring,
            0 if ring is None else (ring if window is None else window),
            hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attn launch failed: error {err}")
    paged_decode_attn.launches += 1
    return out


paged_decode_attn.launches = 0
