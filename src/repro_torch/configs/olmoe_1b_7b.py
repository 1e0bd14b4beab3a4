"""olmoe-1b-7b: 64-expert top-8 MoE [arXiv:2409.02060]. Same numbers as
``repro/configs/olmoe_1b_7b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                         # every FFN is MoE
    vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    moe_every=1,
    source="[arXiv:2409.02060] OLMoE: Open Mixture-of-Experts Language Models",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=0,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        moe_every=1,
        remat=False,
        source=CONFIG.source,
    )
