"""llama-3.2-vision-11b: VLM backbone with interleaved gated
cross-attention image layers [hf:meta-llama/Llama-3.2-11B-Vision]. Same
numbers as ``repro/configs/llama32_vision_11b.py``.

The ViT vision encoder and projector are a stub, as in the JAX package:
the model takes precomputed patch embeddings of shape
``(batch, n_media_tokens, d_model)``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,            # 8 cross-attn layers in 40
    n_media_tokens=1600,           # one tile of 1601-1 patch embeddings (stub)
    source="[hf:meta-llama/Llama-3.2-11B-Vision]",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        cross_attn_every=2,
        n_media_tokens=16,
        remat=False,
        source=CONFIG.source,
    )
