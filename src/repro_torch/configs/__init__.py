from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      TrainConfig, WASGDConfig, dtype_of)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "ModelConfig", "MoEConfig", "SSMConfig", "TrainConfig",
           "WASGDConfig", "dtype_of", "get_config", "get_smoke_config"]
