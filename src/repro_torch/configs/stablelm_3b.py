"""stablelm-3b: dense decoder, the 3B member of the stablelm-2 family
[hf:stabilityai/stablelm-2-1_6b]. Same numbers as
``repro/configs/stablelm_3b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    source="[hf:stabilityai/stablelm-2-1_6b] (3B family member)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=216,
        vocab_size=512,
        remat=False,
        source=CONFIG.source,
    )
