from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (
    PagedKV,
    cache_layout,
    cast_params,
    check_dense,
    decode_step_paged,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "PagedKV",
    "cache_layout",
    "cast_params",
    "check_dense",
    "decode_step_paged",
    "init_cache",
    "init_params",
    "params_from_numpy",
    "prefill",
]
