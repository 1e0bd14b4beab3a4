from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          global_norm, lr_schedule,
                                          make_optimizer)

__all__ = ["Optimizer", "clip_by_global_norm", "global_norm", "lr_schedule",
           "make_optimizer"]
