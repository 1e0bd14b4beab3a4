"""gemma3-1b: dense decoder with 5:1 local:global sliding-window attention
and a 262k vocab [hf:google/gemma-3-1b-pt]. Same numbers as
``repro/configs/gemma3_1b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    attn_window=512,               # local layers: 512-token sliding window
    global_attn_every=6,           # 5 local : 1 global
    tie_embeddings=True,
    logits_softcap=30.0,
    source="[hf:google/gemma-3-1b-pt]",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_window=16,
        global_attn_every=2,
        tie_embeddings=True,
        logits_softcap=30.0,
        remat=False,
        source=CONFIG.source,
    )
