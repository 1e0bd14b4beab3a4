"""stablelm-1.6b: dense decoder, the model of ``examples/quickstart.py``
[hf:stabilityai/stablelm-2-1_6b]. Same numbers as
``repro/configs/stablelm_1_6b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    source="[hf:stabilityai/stablelm-2-1_6b]",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=176,
        vocab_size=512,
        remat=False,
        source=CONFIG.source,
    )
