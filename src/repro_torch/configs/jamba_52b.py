"""jamba-v0.1-52b: hybrid Mamba+attention (1:7 attn:mamba interleave) with
16-expert top-2 MoE every other layer [arXiv:2403.19887]. Same numbers as
``repro/configs/jamba_52b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    moe_every=2,                   # MoE every other layer, dense FFN otherwise
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk_size=64),
    attn_every=8,                  # 1 attention layer per 8 (1:7 interleave)
    source="[arXiv:2403.19887] Jamba: A Hybrid Transformer-Mamba Language Model",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256),
        moe_every=2,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=32, chunk_size=16),
        attn_every=2,
        remat=False,
        source=CONFIG.source,
    )
