"""musicgen-large: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. Same numbers as ``repro/configs/musicgen_large.py``.

The EnCodec codec (the audio front end) is a stub, as in the JAX package:
the model takes the 4 parallel codebook token streams directly
(``tokens: (batch, seq, n_codebooks)`` int32), sums their embeddings and
has 4 parallel output heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    source="[arXiv:2306.05284] Simple and Controllable Music Generation",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="audio",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=256,
        n_codebooks=4,
        remat=False,
        source=CONFIG.source,
    )
