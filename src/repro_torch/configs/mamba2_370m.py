"""mamba2-370m: attention-free SSM with state-space duality (SSD)
[arXiv:2405.21060]. Same numbers as ``repro/configs/mamba2_370m.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=64),
    attn_every=0,                  # pure SSM: no attention layers
    tie_embeddings=True,
    source="[arXiv:2405.21060] Transformers are SSMs (Mamba-2)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=32, chunk_size=16),
        attn_every=0,
        tie_embeddings=True,
        remat=False,
        source=CONFIG.source,
    )
