"""Training state for WASGD rounds, the counterpart of
``repro/train/state.py``. ``step`` is a host integer (the JAX package
keeps it on the device); everything else lives on the device."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.tree import tree_leaves


class TrainState(NamedTuple):
    step: int                # round counter
    params: Dict             # worker-stacked parameter tree
    opt_state: Any
    energy: torch.Tensor     # (p,) accumulated loss energies (reset per round)
    comm_state: Any          # rule-specific (policy state, or ())


def init_state(params: Dict, opt_state: Any, n_workers: int,
               comm_state: Any = ()) -> TrainState:
    dev = tree_leaves(params)[0].device
    return TrainState(
        step=0,
        params=params,
        opt_state=opt_state,
        energy=torch.zeros(n_workers, dtype=torch.float32, device=dev),
        comm_state=comm_state,
    )
