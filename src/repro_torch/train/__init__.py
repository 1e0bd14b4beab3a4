from repro_torch.train.lm import make_lm_loss
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import (build_train_step, init_comm_state,
                                    wasgd_rule)
from repro_torch.train.trainer import Trainer

__all__ = ["TrainState", "Trainer", "build_train_step", "init_comm_state",
           "init_state", "make_lm_loss", "wasgd_rule"]
