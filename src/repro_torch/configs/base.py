"""The port's configs, with the same names, fields and defaults as
``repro/configs/base.py``: ``MoEConfig``, ``SSMConfig``, ``ModelConfig``
(the fields and predicates the serving and training paths read),
``WASGDConfig``, ``TrainConfig`` and the dry run's four
``INPUT_SHAPES``.

The cross-attention fields (``cross_attn_every``, ``n_media_tokens``)
and ``n_codebooks`` drive the vision and audio archs, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration, field for field as
    ``repro/configs/base.py:20``."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer configuration, field for field as
    ``repro/configs/base.py:32``."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 64
    conv_width: int = 4
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX fields that change only the schedule or the memory, not the
    numbers, are kept so that every arch config carries over as it is:

    * ``windowed_qblock`` takes ``flash_attention_windowed`` (query blocks
      that skip the key blocks outside the window) on sliding-window
      layers, in training and in prefill, as JAX does.
    * ``unroll_attn_scan`` picks how JAX's attention scan is unrolled; the
      port's loop over key blocks is the same for either value.
    * ``sharded_ce`` picks JAX's one-hot or gather form of the same
      per-token CE; the port's ``loss_fn`` takes ``fused_ce`` for both.
    * ``remat`` (True in every full config) recomputes each layer in the
      backward pass of the training round
      (``models.transformer.worker_losses``: ``torch.utils.checkpoint``
      around each layer's ``vmap``).
    """
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
    cross_attn_every: int = 0           # >0 (vlm): cross-attention at
                                        # idx % every == every-1
    n_media_tokens: int = 0             # vlm: patch tokens an example
                                        # (the vision encoder is a stub)
    n_codebooks: int = 0                # audio: parallel EnCodec streams

    # MoE and SSM sub-configs
    moe: Optional[MoEConfig] = None
    moe_every: int = 1                  # MoE at idx % every == every-1
    expert_sharding: str = "ep_data"    # "ep_data": the experts one copy;
                                        # "worker": a copy per worker (JAX's
                                        # dry run reads it; both Trainers
                                        # take expert_copies off the
                                        # TrainConfig)
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0                 # hybrid: attention every n-th layer
                                        # (0 with ssm set: pure SSM)

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    sharded_ce: bool = False            # JAX: one-hot CE form; the port's
                                        # loss takes fused_ce either way
    tie_embeddings: bool = False
    remat: bool = True                  # recompute each layer in the round's
                                        # backward pass
    logits_softcap: float = 0.0
    unroll_attn_scan: bool = False      # schedule only: same flash_attention
    windowed_qblock: bool = False       # q-blocked sliding-window attention

    source: str = ""

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

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

    def param_count(self) -> int:
        """Analytic parameter count (embedding, blocks, head): JAX's
        formula term for term, the number ``launch/train.py`` prints. It
        is not the numel of ``init_params`` (in nine of the ten smoke
        configs it differs from it, in JAX as here)."""
        d = self.d_model
        n = 0
        n += self.padded_vocab * d                       # embed
        if not self.tie_embeddings:
            heads = max(1, self.n_codebooks)
            n += heads * self.padded_vocab * d           # lm head(s)
        for i in range(self.n_layers):
            if self.layer_is_attn(i):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                n += 2 * d                               # norms
                if self.layer_is_cross_attn(i):
                    n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                    n += d
            if self.layer_is_ssm(i):
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                n += d * (2 * di + 2 * s.d_state + nh)        # in_proj
                n += (di + 2 * s.d_state) * (s.conv_width + 1)  # conv + bias
                n += 3 * nh + di                  # A_log, D, dt_bias, norm
                n += di * d + d                   # out proj + final norm
            if self.layer_is_moe(i):
                m = self.moe
                n += d * m.n_experts                          # router
                n += m.n_experts * 3 * d * m.d_ff_expert      # experts
                if m.dense_residual and self.d_ff > 0:
                    n += 3 * d * self.d_ff
                n += d
            elif self.d_ff > 0 and not self.layer_is_ssm(i):
                n += 3 * d * self.d_ff + d                    # dense FFN
        n += d                                                # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        n_moe = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        return self.param_count() - n_moe * inactive


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``; a torch dtype passes through."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class WASGDConfig:
    """The paper's knobs (Alg. 1); see ``repro/configs/base.py`` for each
    field. ``policy`` is a worker-assessment spec (``core/weights.py``) and
    ``backend`` a ``"<schedule>:<codec>"`` aggregation spec
    (``core/backends.py``); both are validated when the config is built
    (the backend when a rule is built)."""
    beta: float = 0.9
    a_tilde: float = 1.0
    tau: int = 4
    strategy: str = "boltzmann"
    policy: str = ""
    m_estimate: int = 100
    record_chunks: int = 4
    order_search: bool = True
    order_keep_score: float = -1.0
    a_schedule: str = "constant"
    anneal_rate: float = 0.05
    quantize_comm: bool = False
    comm_dtype: str = "float32"
    hierarchical: bool = False
    n_pods: int = 1
    sharded_aggregate: bool = False
    backend: str = ""
    async_mode: str = "host_sim"

    def __post_init__(self):
        from repro_torch.core.weights import validate_config_spec
        validate_config_spec(self.strategy, self.policy)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    momentum: float = 0.0
    weight_decay: float = 0.0
    optimizer: str = "sgd"            # sgd | momentum | adamw
    global_batch: int = 256
    seq_len: int = 4096
    wasgd: WASGDConfig = WASGDConfig()
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode
    window_override: Optional[int] = None   # sub-quadratic override for dense archs


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode", window_override=8192),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
