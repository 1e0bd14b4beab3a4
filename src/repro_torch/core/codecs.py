"""Payload codecs, the encoding axis of the aggregation API: what the
Eq. 10 reduce carries for each worker-stacked leaf. The counterpart of
``repro/core/codecs.py``::

    payload, aux = codec.encode(x, ctx)       # what rides the reduce
    m            = codec.decode_reduced(m_hat, aux)

``f32``   identity payload, the reference.
``bf16``  bfloat16 payload; the reduce runs in bfloat16.
``int8``  symmetric per-leaf int8: scale = max|x| / 127 over all p workers
          of the leaf (in ``aux``), q = round(x / scale) half to even.

``codec.error_bound(x, theta, beta)`` bounds ``|out - out_f32|`` per
element for one Eq. 10 step, as in the JAX package. The ``int4`` codec
(stochastic rounding from ``jax.random`` bits that no torch generator
reproduces) is not ported yet; naming it raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

NOT_PORTED = {"int4": "the int4 codec draws its rounding noise from "
                      "jax.random fold-ins and is not ported yet "
                      "(ROADMAP.md queue 1.1)"}


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

class _Int8Codec:
    """Symmetric per-leaf int8: q = round(x/scale), scale = max|x|/127."""

    name = "int8"
    wire_dtype = torch.int8
    reduce_dtype = torch.float32
    quantizing = True

    @staticmethod
    def _scale(x):
        return torch.clamp_min(x.abs().max(), 1e-12) / 127.0

    def encode(self, x, ctx=None):
        scale = self._scale(x)
        q = torch.clamp(torch.round(x.float() / scale), -127, 127)
        return q.to(torch.int8), scale

    def decode_reduced(self, m, aux):
        return m.float() * aux

    def error_bound(self, x, theta, beta):
        # deterministic rounding: per-element error <= scale/2, and the
        # aggregate is a theta-convex combination.
        return (beta * self._scale(x) / 2).float() + 1e-5


_CODECS: Dict[str, object] = {}


def register_codec(codec) -> None:
    """Register a codec instance by its name."""
    if codec.name in _CODECS:
        raise ValueError(f"payload codec {codec.name!r} already registered")
    _CODECS[codec.name] = codec


def get_codec(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"payload codec {name!r}: "
                                  f"{NOT_PORTED[name]}")
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
