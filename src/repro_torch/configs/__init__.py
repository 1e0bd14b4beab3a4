from repro_torch.configs.base import (INPUT_SHAPES, SHAPES_BY_NAME,
                                      InputShape, ModelConfig, MoEConfig,
                                      SSMConfig, TrainConfig, WASGDConfig,
                                      dtype_of)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "MoEConfig", "SHAPES_BY_NAME", "SSMConfig", "TrainConfig",
           "WASGDConfig", "dtype_of", "get_config", "get_smoke_config"]
