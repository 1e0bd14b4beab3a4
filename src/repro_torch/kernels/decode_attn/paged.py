"""Wrapper of the CUDA paged decode-attention kernel
(``csrc/paged_decode_attn.cu``), the port of the Pallas kernel in
``repro/kernels/decode_attn/paged.py:92``.

A tensor on the CPU takes the plain version (``ref.py``); a tensor on a
CUDA device launches the kernel, or the call raises. There is no fallback
from a failed build or launch. ``paged_decode_attn.launches`` counts the
kernel's launches: one device kernel per call, which merges its splits
itself (the splits of a row are one thread block cluster). q and the pools take
any pair of float32 and bfloat16, 1 <= g <= 8 and any head_dim that is a
multiple of 16 up to 256.
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
_MAX_G = 8
_MAX_HD = 256
_STAGE = 32                     # tokens per shared-memory stage
_MAX_SPLITS = 16                # a thread block cluster: the row's splits
_TABLE_CAP = 1024               # table entries one split may span
_TARGET_BLOCKS = 132            # one CUDA block for each of the 132 SMs


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("paged_decode_attn").paged_decode_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, kv: int, n_blk: int, bs: int):
    """(slots per split, splits): splits of whole 32-slot tiles (a split's
    copies go in flight together), enough CUDA blocks to cover the card's
    SMs when b * kv is small, at most ``_MAX_SPLITS`` splits (one thread
    block cluster a row), and a split spans at most ``_TABLE_CAP`` table
    entries."""
    S = n_blk * bs
    tiles = math.ceil(S / _STAGE)
    want = max(1, math.ceil(_TARGET_BLOCKS / (b * kv)))
    per = max(math.ceil(tiles / want), math.ceil(tiles / _MAX_SPLITS)) * _STAGE
    if math.ceil(per / bs) + 1 > _TABLE_CAP:
        raise ValueError(f"a table of {n_blk} blocks of {bs} slots needs "
                         f"splits of {per} slots, past {_TABLE_CAP} table "
                         f"entries")
    return per, math.ceil(S / per)


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
    check_shapes(q.dtype, k_pool.dtype, g, hd)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("index", index)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:           # the kernel's 16-byte copies
            raise ValueError(f"{name} must be 16-byte aligned")


def check_shapes(q_dtype: torch.dtype, kv_dtype: torch.dtype, g: int,
                 hd: int) -> None:
    """What both decode kernels take: q and the cache each float32 or
    bfloat16, 1 <= g <= 8, hd a multiple of 16 up to 256."""
    for name, dt in (("q", q_dtype), ("cache", kv_dtype)):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, not {dt}")
    if not 1 <= g <= _MAX_G or hd % 16 or not 16 <= hd <= _MAX_HD:
        raise ValueError(f"unsupported group size {g} or head_dim {hd}: the "
                         f"kernel takes 1 <= g <= {_MAX_G} and hd a multiple "
                         f"of 16 up to {_MAX_HD}")


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
    if dev.type in ("cpu", "meta"):
        return paged_decode_attn_ref(q, k_pool, v_pool, block_table, index,
                                     ring=ring, window=window)
    if dev.type != "cuda":
        raise ValueError(
            f"paged_decode_attn runs on cpu, meta or cuda, not {dev}")
    _check(q, k_pool, v_pool, block_table, index)
    b, kv, g, hd = q.shape
    bs = k_pool.shape[1]
    n_blk = block_table.shape[1]
    check_ring(ring, n_blk, bs)
    per, n_split = split_plan(b, kv, n_blk, bs)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _launch_fn()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), index.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], b, kv, g, hd, bs,
            n_blk, per, n_split, 0 if ring is None else ring,
            0 if ring is None else (ring if window is None else window),
            hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attn launch failed: error {err}")
    paged_decode_attn.launches += 1
    return out


paged_decode_attn.launches = 0
