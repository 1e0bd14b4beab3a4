"""yi-6b: dense llama-architecture GQA decoder [arXiv:2403.04652]. Same
numbers as ``repro/configs/yi_6b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="[arXiv:2403.04652] Yi: Open Foundation Models by 01.AI",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=344,
        vocab_size=512,
        remat=False,
        source=CONFIG.source,
    )
