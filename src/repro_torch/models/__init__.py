from repro_torch.models.cnn import (classification_loss, cnn6_apply,
                                   init_cnn6, init_mlp, mlp_apply)
from repro_torch.models.convert import (cnn6_from_jax, cnn6_to_jax,
                                       params_from_numpy)
from repro_torch.models.transformer import (
    PagedKV,
    cache_layout,
    cast_params,
    check_dense,
    decode_step_paged,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_axes,
    prefill,
)

__all__ = [
    "PagedKV",
    "cache_layout",
    "cast_params",
    "check_dense",
    "classification_loss",
    "cnn6_apply",
    "cnn6_from_jax",
    "cnn6_to_jax",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_cnn6",
    "init_mlp",
    "init_params",
    "loss_fn",
    "mlp_apply",
    "param_axes",
    "params_from_numpy",
    "prefill",
]
