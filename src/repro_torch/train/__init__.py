from repro_torch.train.lm import make_lm_loss
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import (build_train_step, easgd_rule,
                                    init_comm_state, mwu_rule, no_comm_rule,
                                    spsgd_rule, wasgd_rule)
from repro_torch.train.trainer import RULES, Trainer

__all__ = ["RULES", "TrainState", "Trainer", "build_train_step",
           "easgd_rule", "init_comm_state", "init_state", "make_lm_loss",
           "mwu_rule", "no_comm_rule", "spsgd_rule", "wasgd_rule"]
