"""LM glue, the counterpart of ``repro/train/lm.py``: a ``ModelConfig``
wired into the ``loss_fn(params, batch)`` the round builder and the
``Trainer`` take (``make_lm_loss``), and the dry run's abstract state and
batch (``abstract_lm_state``, ``lm_batch_specs``): meta tensors and their
logical-axes trees, so full-size parameters are never allocated.

The loss also has the model's worker-stacked form, ``loss.stacked``
(``models.transformer.worker_losses``; ``train.step.StackedLoss``): the
round takes it in place of a ``vmap`` of the whole loss, so that
``cfg.remat`` can checkpoint each layer outside its ``vmap``."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.ssd_chunk import ssd_chunked_kernel
from repro_torch.models.param import META, add_worker_axis, is_expert_path
from repro_torch.models.transformer import abstract_params
from repro_torch.models.transformer import loss_fn as lm_loss
from repro_torch.models.transformer import worker_losses
from repro_torch.optim import Optimizer, make_optimizer
from repro_torch.optim.optimizers import AdamState
from repro_torch.train.state import TrainState
from repro_torch.train.step import init_comm_state
from repro_torch.tree import tree_map


class LMLoss:
    """``loss(params, batch) -> (loss, {"ce", "moe_loss"})`` of one model
    and ``loss.stacked(params, in_dims, batch) -> (losses (p,), aux)`` of
    worker-stacked params, both through ``norm``, ``ce`` and ``ssd``."""

    def __init__(self, cfg: ModelConfig, norm: Callable, ce: Callable,
                 ssd: Callable):
        self.cfg, self.norm, self.ce, self.ssd = cfg, norm, ce, ssd

    def __call__(self, params: Dict, batch: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
        return lm_loss(self.cfg, params, batch, norm=self.norm, ce=self.ce,
                       ssd=self.ssd)

    def stacked(self, params: Dict, in_dims: Dict, batch: Dict
                ) -> Tuple[torch.Tensor, Dict]:
        return worker_losses(self.cfg, params, in_dims, batch,
                             norm=self.norm, ce=self.ce, ssd=self.ssd)


def make_lm_loss(cfg: ModelConfig, *, norm: Callable = rmsnorm_kernel,
                 ce: Callable = fused_ce,
                 ssd: Callable = ssd_chunked_kernel) -> LMLoss:
    """The loss of ``cfg`` through the kernels (``models.transformer.
    loss_fn``'s defaults), or through ``norm``, ``ce`` and ``ssd`` when
    given (the kernels' plain versions, for an agreement check)."""
    return LMLoss(cfg, norm, ce, ssd)


def opt_axes_like(opt_name: str, opt_shapes: Any, param_axes: Dict) -> Any:
    """Logical axes for the optimizer state (mirrors params where
    stateful)."""
    if opt_name == "sgd":
        return ()
    if opt_name == "momentum":
        return param_axes
    if opt_name == "adamw":
        return AdamState(mu=param_axes, nu=param_axes, count=())
    raise ValueError(opt_name)


def abstract_lm_state(cfg: ModelConfig, tcfg: TrainConfig, n_workers: int
                      ) -> Tuple[TrainState, TrainState, Optimizer]:
    """(state of meta tensors, state logical-axes, optimizer), as JAX's.
    The comm state is ``train.step.init_comm_state``'s for the wasgd rule:
    the Alg. 4 ``(w,)`` activity mask under ``async_mode="on_device"``,
    the stateful policy's state (``{"active", "policy"}`` with both),
    ``()`` otherwise. ``step`` is the port's host int: its axes are ``()``
    and it holds no device byte."""
    shapes, axes = abstract_params(cfg)
    skip = is_expert_path if (cfg.moe is not None
                              and cfg.expert_sharding == "ep_data") else None
    shapes, axes = add_worker_axis(shapes, axes, n_workers, skip=skip)
    optimizer = make_optimizer(tcfg.optimizer, tcfg.learning_rate,
                               tcfg.momentum, tcfg.weight_decay)
    opt_shapes = optimizer.init(shapes)
    o_axes = opt_axes_like(optimizer.name, opt_shapes, axes)

    comm = init_comm_state("wasgd", shapes, axes, n_workers, tcfg.wasgd)

    def pax(x):
        return tuple("worker" if (i == 0 and x.shape[0] == n_workers)
                     else None for i in range(x.dim()))

    if tcfg.wasgd.async_mode == "on_device":
        comm_axes = ({"active": ("worker",),
                      "policy": tree_map(pax, comm["policy"])}
                     if isinstance(comm, dict) else ("worker",))
    else:
        comm_axes = tree_map(pax, comm) if isinstance(comm, dict) else ()
    state_shapes = TrainState(
        step=0,
        params=shapes,
        opt_state=opt_shapes,
        energy=torch.empty(n_workers, dtype=torch.float32, device=META),
        comm_state=comm,
    )
    state_axes = TrainState(
        step=(),
        params=axes,
        opt_state=o_axes,
        energy=("worker",),
        comm_state=comm_axes,
    )
    return state_shapes, state_axes, optimizer


def lm_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int
                   ) -> Tuple[Dict, Dict]:
    """(batch of meta tensors, batch logical-axes) for one training round:
    tokens and labels in int32 (the port's data pipeline's index dtype),
    media in bfloat16, as JAX's."""
    if cfg.n_codebooks > 0:
        shape = (global_batch, seq_len, cfg.n_codebooks)
        tok_axes = ("worker", None, None)
    else:
        shape = (global_batch, seq_len)
        tok_axes = ("worker", None)

    def tok():
        return torch.empty(shape, dtype=torch.int32, device=META)

    shapes = {"tokens": tok(), "labels": tok()}
    axes = {"tokens": tok_axes, "labels": tok_axes}
    if cfg.n_media_tokens > 0:
        shapes["media"] = torch.empty(
            (global_batch, cfg.n_media_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=META)
        axes["media"] = ("worker", None, None)
    return shapes, axes
