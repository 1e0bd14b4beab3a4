"""Meta-tensor stand-ins for every (architecture x input-shape) workload,
the counterpart of ``repro/launch/specs.py``.

``input_specs`` returns everything the dry run needs to trace one step:
the argument trees as tensors on ``torch.device("meta")``, the matching
logical-axes trees, the step callable, and the rules table, without
allocating a device byte. Two arguments are host values, as the port
keeps them: ``TrainState.step`` and the decode step's ``index`` (the
host's loop counter; a full cache, ``seq_len - 1``). Their axes are
``()``, as JAX's 0-d counters', and they count no bytes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import (InputShape, ModelConfig, TrainConfig)
from repro_torch.models.param import META
from repro_torch.models.transformer import (abstract_params, cache_axes,
                                            decode_step, init_cache, prefill)
from repro_torch.parallel.sharding import (SERVE_LONG_RULES, SERVE_RULES,
                                           TRAIN_RULES)
from repro_torch.train.lm import (abstract_lm_state, lm_batch_specs,
                                  make_lm_loss)
from repro_torch.train.step import build_train_step


def effective_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the long-context sub-quadratic override: pure full-attention
    architectures run ``long_500k`` only under an explicit sliding-window
    variant."""
    if (shape.window_override and cfg.ssm is None and cfg.attn_window is None
            and shape.kind == "decode"):
        return dataclasses.replace(cfg, attn_window=shape.window_override,
                                   global_attn_every=0)
    return cfg


class Workload(NamedTuple):
    fn: Any                     # the step to trace
    arg_shapes: tuple           # meta-tensor trees (positional)
    arg_axes: tuple             # logical-axes trees (same structure)
    rules: Dict                 # logical-axis -> mesh-axis table
    cfg: ModelConfig            # effective model config
    meta: Dict


def _tokens(cfg: ModelConfig, batch: int, seq: int, seq_axis):
    """int32 token ids (b, s), or (b, s, n_q) for codebooks, and their
    axes."""
    if cfg.n_codebooks > 0:
        return (torch.empty((batch, seq, cfg.n_codebooks), dtype=torch.int32,
                            device=META), ("batch", seq_axis, None))
    return (torch.empty((batch, seq), dtype=torch.int32, device=META),
            ("batch", seq_axis))


def _media(cfg: ModelConfig, batch: int):
    return (torch.empty((batch, cfg.n_media_tokens, cfg.d_model),
                        dtype=torch.bfloat16, device=META),
            ("batch", "media", None))


def input_specs(cfg: ModelConfig, shape: InputShape, n_workers: int,
                tcfg: Optional[TrainConfig] = None,
                for_dryrun: bool = True,
                train_rules: Optional[Dict] = None) -> Workload:
    cfg = effective_config(cfg, shape)
    if for_dryrun:
        # JAX unrolls its flash-attention KV scan so that XLA's cost
        # analysis counts every block; the port's loop runs in Python, so
        # the flag only keeps the two configs equal
        cfg = dataclasses.replace(cfg, unroll_attn_scan=True)
    tcfg = tcfg or TrainConfig()

    if shape.kind == "train":
        state_shapes, state_axes, optimizer = abstract_lm_state(
            cfg, tcfg, n_workers)
        batch_shapes, batch_axes = lm_batch_specs(
            cfg, shape.global_batch, shape.seq_len)
        step = build_train_step(make_lm_loss(cfg), optimizer,
                                state_axes.params, tcfg.wasgd, n_workers)
        rules = TRAIN_RULES if train_rules is None else train_rules
        return Workload(step, (state_shapes, batch_shapes),
                        (state_axes, batch_axes), rules, cfg,
                        {"kind": "train", "tau": tcfg.wasgd.tau,
                         "workers": n_workers})

    params_shapes, params_axes = abstract_params(cfg)
    rules = SERVE_LONG_RULES if shape.global_batch == 1 else SERVE_RULES
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       torch.bfloat16, device=META)
    cax = cache_axes(cfg)

    if shape.kind == "prefill":
        tok, tok_axes = _tokens(cfg, shape.global_batch, shape.seq_len,
                                "seq")
        args = [params_shapes, tok, cache]
        axes = [params_axes, tok_axes, cax]
        if cfg.n_media_tokens > 0:
            media, media_axes = _media(cfg, shape.global_batch)
            args.append(media)
            axes.append(media_axes)
        fn = functools.partial(prefill, cfg)
        return Workload(fn, tuple(args), tuple(axes), rules, cfg,
                        {"kind": "prefill"})

    # decode: one new token against a seq_len-deep cache
    tok, tok_axes = _tokens(cfg, shape.global_batch, 1, None)
    args = [params_shapes, tok, cache, shape.seq_len - 1]
    axes = [params_axes, tok_axes, cax, ()]
    if cfg.n_media_tokens > 0:
        media, media_axes = _media(cfg, shape.global_batch)
        args.append(media)
        axes.append(media_axes)
    fn = functools.partial(decode_step, cfg)
    return Workload(fn, tuple(args), tuple(axes), rules, cfg,
                    {"kind": "decode"})
