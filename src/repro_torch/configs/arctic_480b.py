"""arctic-480b: 128-expert top-2 MoE with a dense residual MLP
[hf:Snowflake/snowflake-arctic-base]. Same numbers as
``repro/configs/arctic_480b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,                      # dense residual MLP hidden
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
    moe_every=1,
    source="[hf:Snowflake/snowflake-arctic-base]",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=96,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, dense_residual=True),
        moe_every=1,
        remat=False,
        source=CONFIG.source,
    )
