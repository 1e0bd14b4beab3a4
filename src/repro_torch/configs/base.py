"""The port's ``ModelConfig``: the fields and predicates the dense serving
path reads, with the same names and meaning as ``repro/configs/base.py``.

The MoE, SSM, cross-attention and codebook fields are kept so that a config
can say what it is; the port's model raises ``NotImplementedError`` on any
of them (``models.transformer.check_dense``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    # Attention pattern
    attn_window: Optional[int] = None   # sliding-window size; None = full
    global_attn_every: int = 0          # >0: layer idx % every == every-1 is global
    cross_attn_every: int = 0           # >0 (vlm): not served by the port
    n_codebooks: int = 0                # audio: not served by the port

    # MoE / SSM sub-configs (not served by the port)
    moe: Optional[Any] = None
    moe_every: int = 1
    ssm: Optional[Any] = None
    attn_every: int = 0

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    source: str = ""

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / 256) * 256)

    def layer_is_attn(self, idx: int) -> bool:
        if self.ssm is None:
            return True
        if self.attn_every <= 0:
            return False
        return idx % self.attn_every == self.attn_every - 1

    def layer_is_ssm(self, idx: int) -> bool:
        return self.ssm is not None and not self.layer_is_attn(idx)

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe_every == self.moe_every - 1

    def layer_is_global_attn(self, idx: int) -> bool:
        if self.attn_window is None:
            return True
        if self.global_attn_every <= 0:
            return False
        return idx % self.global_attn_every == self.global_attn_every - 1

    def layer_is_cross_attn(self, idx: int) -> bool:
        if self.cross_attn_every <= 0:
            return False
        return idx % self.cross_attn_every == self.cross_attn_every - 1

    def window_for_layer(self, idx: int) -> Optional[int]:
        if self.attn_window is not None and not self.layer_is_global_attn(idx):
            return self.attn_window
        return None


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``; a torch dtype passes through."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
