from repro_torch.train.lm import make_lm_loss
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import (PIPELINE_MODES, async_wasgd_rule,
                                    build_phased_train_step,
                                    build_train_step, easgd_rule,
                                    init_comm_state, mwu_rule, no_comm_rule,
                                    spsgd_rule, wasgd_rule)
from repro_torch.train.trainer import RULES, Trainer

__all__ = ["PIPELINE_MODES", "RULES", "TrainState", "Trainer",
           "async_wasgd_rule", "build_phased_train_step", "build_train_step",
           "easgd_rule", "init_comm_state", "init_state", "make_lm_loss",
           "mwu_rule", "no_comm_rule", "spsgd_rule", "wasgd_rule"]
