from repro_torch.optim.optimizers import Optimizer, make_optimizer

__all__ = ["Optimizer", "make_optimizer"]
