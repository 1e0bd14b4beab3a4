"""Wrapper of the CUDA fused aggregation kernel (``csrc/wagg_fused.cu``),
the port of the Pallas kernel in ``repro/kernels/wagg/wagg.py:88``.

``wagg_fused_many`` aggregates many leaves that share theta, beta and the
mask: every leaf with the same (x, payload) types goes into launches of
up to ``MAX_LEAVES`` leaves (``group_plan``), each leaf's codec scale
folded into theta inside the kernel. ``wagg_fused`` is the one-leaf entry,
a group of one. Tensors on the CPU or the meta device take the plain
version (``ref.py``) leaf by leaf; tensors on a CUDA device launch the
kernel, or the call raises. There is no fallback from a failed build or
launch. ``wagg_fused.launches`` counts the kernel's launches,
``wagg_fused.leaves`` the leaves they aggregated and
``wagg_fused.masked_launches`` the launches with an Alg. 4 mask.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Hashable, List, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wagg.ref import wagg_fused_ref

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SAME_AS_X = 3                   # payload code: the payload is x itself

THREADS = 256                   # threads a block (the kernel's kThreads)
MAX_LEAVES = 80                 # leaves a launch's table holds (kMaxLeaves)
_ALIGNED, _SCALE_BF16 = 1, 2    # Leaf.flags


class _Leaf(ctypes.Structure):
    """The kernel's ``Leaf`` (48 bytes)."""
    _fields_ = [("x", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("chunk_begin", ctypes.c_int),
                ("flags", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("wagg_fused").wagg_fused_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
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


def _check_scale(scale):
    if scale.numel() != 1 or scale.dtype not in (torch.float32,
                                                 torch.bfloat16):
        raise ValueError(f"a scale must be one float32 or bfloat16 element, "
                         f"not {tuple(scale.shape)} {scale.dtype}")


def columns_per_thread(x_dtype: torch.dtype) -> int:
    """V: the columns a thread owns, 16 bytes of x (4 float32, 8 bf16)."""
    return 16 // x_dtype.itemsize


def rows_aligned(p: int, n: int, vec: int, *tensors: torch.Tensor) -> bool:
    """Whether every row of every (p, n) tensor starts on its vector-load
    boundary (``vec`` elements, at most 16 bytes): the aligned base
    pointers, and n a multiple of ``vec`` when there is more than one
    row. Such a leaf takes 16-byte loads; any other the strided path."""
    if p > 1 and n % vec:
        return False
    return all(t.data_ptr() % min(16, vec * t.element_size()) == 0
               for t in tensors)


def chunk_begins(ns: Sequence[int], vec: int) -> List[int]:
    """The first chunk of each leaf of a launch, and the total last: the
    prefix sum of ceil(n / (THREADS * vec)), one block per chunk."""
    out = [0]
    for n in ns:
        out.append(out[-1] + -(-n // (THREADS * vec)))
    return out


def group_plan(keys: Sequence[Hashable],
               max_leaves: int = MAX_LEAVES) -> List[List[int]]:
    """The launches of a call: the leaf indices of each key (the (x,
    payload) dtype pair), keys in order of first appearance, each key's
    leaves in their order, cut into runs of at most ``max_leaves``."""
    by_key = {}
    for i, k in enumerate(keys):
        by_key.setdefault(k, []).append(i)
    return [idx[s:s + max_leaves] for idx in by_key.values()
            for s in range(0, len(idx), max_leaves)]


def _theta_eff(theta, scale):
    theta = theta.float()
    return theta if scale is None else theta * scale.float()


def wagg_fused_many(xs: Sequence[torch.Tensor], theta: torch.Tensor, beta,
                    payloads: Optional[Sequence] = None,
                    scales: Optional[Sequence] = None,
                    active: Optional[torch.Tensor] = None
                    ) -> List[torch.Tensor]:
    """Eq. 10 on many leaves: xs[i] (p, N_i) float32/bfloat16; theta (p,)
    shared; payloads[i] (p, N_i) float32/bfloat16/int8 or None (the payload
    is x); scales[i] a one-element float32/bfloat16 tensor (the codec's
    scale, folded into theta as ``theta * scale`` in float32) or None;
    active (p,) float32 0/1 or None, shared. Returns one (p, N_i) tensor
    in x's dtype a leaf, as ``wagg_fused`` would for each."""
    xs = list(xs)
    k = len(xs)
    payloads = [None] * k if payloads is None else list(payloads)
    scales = [None] * k if scales is None else list(scales)
    if len(payloads) != k or len(scales) != k:
        raise ValueError(f"{k} leaves, {len(payloads)} payloads and "
                         f"{len(scales)} scales")
    if k == 0:
        return []
    tensors = [t for t in (*xs, theta, *payloads, *scales, active)
               if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "meta"):
        return [wagg_fused_ref(x, _theta_eff(theta, s), beta, payload=q,
                               active=active)
                for x, q, s in zip(xs, payloads, scales)]
    if dev.type != "cuda":
        raise ValueError(f"wagg_fused runs on cpu, meta or cuda, not {dev}")
    theta = theta.to(torch.float32)
    p = theta.shape[0]
    keys = []
    for x, q, s in zip(xs, payloads, scales):
        _check(x, theta, q, active)
        if s is not None:
            _check_scale(s)
        same = q is None or (q.data_ptr() == x.data_ptr()
                             and q.dtype == x.dtype)
        keys.append((x.dtype, SAME_AS_X if same else _Q_CODE[q.dtype]))
    outs = [torch.empty_like(x) for x in xs]
    plan = group_plan(keys)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for idx in plan:
            x_dtype, q_code = keys[idx[0]]
            vec = columns_per_thread(x_dtype)
            begins = chunk_begins([xs[i].shape[1] for i in idx], vec)
            table = (_Leaf * len(idx))()
            for slot, i in enumerate(idx):
                x, s, out = xs[i], scales[i], outs[i]
                q = x if q_code == SAME_AS_X else payloads[i]
                flags = _ALIGNED if rows_aligned(p, x.shape[1], vec, x, q,
                                                 out) else 0
                if s is not None and s.dtype == torch.bfloat16:
                    flags |= _SCALE_BF16
                table[slot] = _Leaf(x.data_ptr(), q.data_ptr(),
                                    out.data_ptr(),
                                    None if s is None else s.data_ptr(),
                                    x.shape[1], begins[slot], flags)
            err = _launch_fn()(
                ctypes.addressof(table), len(idx), begins[-1],
                theta.data_ptr(),
                None if active is None else active.data_ptr(), p,
                _X_CODE[x_dtype], q_code, 1.0 - beta, beta, stream)
            if err != 0:
                raise RuntimeError(f"wagg_fused launch failed: error {err}")
    wagg_fused.launches += len(plan)
    wagg_fused.leaves += k
    wagg_fused.masked_launches += len(plan) if active is not None else 0
    return outs


def wagg_fused(x: torch.Tensor, theta: torch.Tensor, beta: float,
               payload: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (p, N) float32/bfloat16; theta: (p,) effective weights (a
    quantizing codec's scale folded in); payload: (p, N) float32/bfloat16/
    int8 or None (the payload is x); active: (p,) float32 0/1 or None (the
    caller casts a mask once for all its leaves). Returns (p, N) in x's
    dtype: ``wagg_fused_many`` on one leaf."""
    return wagg_fused_many([x], theta, beta, payloads=[payload],
                           active=active)[0]


wagg_fused.launches = 0
wagg_fused.leaves = 0
wagg_fused.masked_launches = 0
