"""Payload codecs, the encoding axis of the aggregation API: what the
Eq. 10 reduce carries for each worker-stacked leaf. The counterpart of
``repro/core/codecs.py``::

    payload, aux = codec.encode(x, ctx)       # what rides the reduce
    m            = codec.decode_reduced(m_hat, aux)

``f32``   identity payload, the reference.
``bf16``  bfloat16 payload; the reduce runs in bfloat16.
``int8``  symmetric per-leaf int8: scale = max|x| / 127 over all p workers
          of the leaf (in ``aux``), q = round(x / scale) half to even.
``int4``  int4-range stochastic rounding, carried in int8: scale =
          max|x| / 7, q = clip(floor(x / scale + u), -7, 7) with u
          uniform in [0, 1), so E[q] = x / scale.

``codec.error_bound(x, theta, beta)`` bounds ``|out - out_f32|`` per
element for one Eq. 10 step, as in the JAX package.

The int4 draw cannot be JAX's (threefry fold-ins, which no torch generator
reproduces). It is a counter-based hash in integer torch ops, so the CPU
and a CUDA card draw the same bits: a 32-bit key mixes ``ctx.key``
(default ``0x144``, JAX's), the leaf's size, the wrapping u32 sum of its
float32 bits (JAX's content hash: fresh noise whenever the parameters
change) and ``ctx.leaf_index`` (distinct noise for equal-content leaves);
element ``i`` draws ``mix32(i * golden + key)``, whose top 24 bits give u.
The hash runs on int32 lanes holding the u32 bits: products wrap modulo
2^32 and right shifts are made logical by a mask.

Under a device mesh (``ctx.mesh``) a worker leaf holds this shard's rows
(``core/shardmap_agg.py``). The quantizing codecs then encode the whole
leaf as the meshless codec does: the scale's max and the int4 key's size
and content sum are reduced over the worker group, and element ``i`` of
the shard is element ``i + shard * numel`` of the leaf, so every rank's
rows of the payload are the meshless payload's rows, bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import shardmap_agg

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
# lowbias32's xorshift-multiply rounds, then a last xorshift by 16
_MIX = ((16, 0x7FEB352D), (15, 0x846CA68B))
INT4_DEFAULT_KEY = 0x144
# elements a chunk of the int4 encode: its temporaries stay at 64 MiB
# each whatever the leaf's size
INT4_CHUNK = 1 << 24


class _DtypeCodec:
    """Pure dtype-cast codec (f32 / bf16): payload = x cast to the dtype."""

    quantizing = False

    def __init__(self, name: str, dtype: torch.dtype):
        self.name = name
        self.wire_dtype = dtype
        self.reduce_dtype = dtype

    def encode(self, x, ctx=None):
        return x.to(self.wire_dtype), None

    def decode_reduced(self, m, aux):
        return m.float()

    def error_bound(self, x, theta, beta):
        if self.wire_dtype == torch.float32:
            return torch.tensor(1e-5, dtype=torch.float32, device=x.device)
        # operand rounding (2^-9 relative each) plus bf16 accumulation over
        # the worker axis: linear-in-w worst case, plus float noise.
        w = theta.shape[0]
        return (beta * (w + 4) * 2.0 ** -8 * x.abs().max().float() + 1e-5)


def _mesh(ctx):
    return getattr(ctx, "mesh", None)


def _leaf_absmax(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """max|x| over the leaf (every shard's rows under a mesh), in x's
    dtype, without an |x| temporary the size of the leaf."""
    amax = torch.maximum(x.max(), -x.min())
    if mesh is not None:
        shardmap_agg.all_reduce_(amax, mesh, op=dist.ReduceOp.MAX)
    return amax


class _Int8Codec:
    """Symmetric per-leaf int8: q = round(x/scale), scale = max|x|/127."""

    name = "int8"
    wire_dtype = torch.int8
    reduce_dtype = torch.float32
    quantizing = True

    @staticmethod
    def _scale(x, mesh=None):
        return torch.clamp_min(_leaf_absmax(x, mesh), 1e-12) / 127.0

    def encode(self, x, ctx=None):
        scale = self._scale(x, _mesh(ctx))
        q = torch.clamp(torch.round(x.float() / scale), -127, 127)
        return q.to(torch.int8), scale

    def decode_reduced(self, m, aux):
        return m.float() * aux

    def error_bound(self, x, theta, beta):
        # deterministic rounding: per-element error <= scale/2, and the
        # aggregate is a theta-convex combination.
        return (beta * self._scale(x) / 2).float() + 1e-5


def _i32(v: int) -> int:
    """The int32 with the bits of ``v`` mod 2^32."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _xorshift_(h: torch.Tensor, shift: int) -> torch.Tensor:
    """h ^= h >>> shift on int32 lanes, in place."""
    return h.bitwise_xor_((h >> shift).bitwise_and_((1 << (32 - shift)) - 1))


def mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32, a bijective 32-bit mix, on int32 lanes, in place."""
    for shift, mult in _MIX:
        _xorshift_(h, shift).mul_(_i32(mult))
    return _xorshift_(h, 16)


def _mixed(v: int) -> int:
    """mix32 of a Python int's low 32 bits, as the int32 of its bits."""
    return int(mix32(torch.tensor(_i32(v), dtype=torch.int32)))


def _chunks(n: int):
    for start in range(0, n, INT4_CHUNK):
        yield start, min(start + INT4_CHUNK, n)


def int4_key(x: torch.Tensor, key=None, leaf_index=None,
             mesh=None) -> torch.Tensor:
    """The leaf's 32-bit draw key, an int32 scalar on x's device: ``key``
    (default ``0x144``), then x's size, then the wrapping u32 sum of x's
    float32 bits, then ``leaf_index`` when given, each mixed in. Under a
    ``mesh`` the size and the sum are the whole leaf's."""
    flat = x.float().reshape(-1)
    bits = flat.view(torch.int32)
    content = sum(bits[a:b].sum() for a, b in _chunks(flat.numel()))
    numel = flat.numel()
    if mesh is not None:
        content = shardmap_agg.all_reduce_(content.reshape(1), mesh)[0]
        numel *= shardmap_agg.mesh_worker_shards(mesh)
    seed = INT4_DEFAULT_KEY if key is None else int(key)
    # the int64 sum's low 32 bits as the int32 of the same bits
    k = (((content & _M32) ^ 1 << 31) - (1 << 31)).to(torch.int32)
    k = mix32(k.add_(_mixed(_mixed(seed) + numel)))
    if leaf_index is not None:
        k = mix32(k.add_(_mixed(int(leaf_index))))
    return k


def int4_uniform(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """u in [0, 1) (float32, multiples of 2^-24) of the flat elements
    [start, stop) under ``key``: mix32(i * golden + key), i = start + j."""
    h = torch.arange(stop - start, dtype=torch.int32, device=key.device)
    h.mul_(_i32(_GOLDEN)).add_(key + _i32(start * _GOLDEN))
    # the top 24 bits as a signed v in [-2^23, 2^23): u = v / 2^24 + 1/2
    return (mix32(h) >> 8).float().mul_(2.0 ** -24).add_(0.5)


class _Int4StochasticCodec:
    """int4-range payload with unbiased stochastic rounding, carried in
    int8. The encode runs in chunks of ``INT4_CHUNK`` elements."""

    name = "int4"
    wire_dtype = torch.int8
    reduce_dtype = torch.float32
    quantizing = True

    @staticmethod
    def _scale(x, mesh=None):
        return torch.clamp_min(_leaf_absmax(x, mesh).float(), 1e-12) / 7.0

    def encode(self, x, ctx=None):
        mesh = _mesh(ctx)
        scale = self._scale(x, mesh)
        key = int4_key(x, getattr(ctx, "key", None),
                       getattr(ctx, "leaf_index", None), mesh=mesh)
        flat = x.float().reshape(-1)
        # this shard's first element in the whole leaf
        off = 0
        if mesh is not None:
            off = shardmap_agg.shard_index(mesh) * flat.numel()
        q = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
        for a, b in _chunks(flat.numel()):
            q[a:b] = torch.addcdiv(int4_uniform(key, off + a, off + b),
                                   flat[a:b], scale).floor_().clamp_(-7, 7)
        return q.reshape(x.shape), scale

    def decode_reduced(self, m, aux):
        return m.float() * aux

    def error_bound(self, x, theta, beta):
        # stochastic rounding: |q * scale - x| < scale (one step), and the
        # aggregate is a theta-convex combination.
        return (beta * self._scale(x)).float() + 1e-5


_CODECS: Dict[str, object] = {}


def register_codec(codec) -> None:
    """Register a codec instance by its name."""
    if codec.name in _CODECS:
        raise ValueError(f"payload codec {codec.name!r} already registered")
    _CODECS[codec.name] = codec


def get_codec(name: str):
    if name not in _CODECS:
        raise KeyError(f"unknown payload codec {name!r}; "
                       f"known: {sorted(_CODECS)}")
    return _CODECS[name]


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_CODECS))


def codec_for_dtype(dtype):
    """``ctx.comm_dtype`` -> codec, for specs that leave the codec open."""
    return get_codec("bf16" if dtype == torch.bfloat16 else "f32")


register_codec(_DtypeCodec("f32", torch.float32))
register_codec(_DtypeCodec("bf16", torch.bfloat16))
register_codec(_Int8Codec())
register_codec(_Int4StochasticCodec())
