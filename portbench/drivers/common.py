"""What the drivers share: the program's configuration of a configuration
file, the card's description in a result, and the synchronize, reset and
release around a window."""
from __future__ import annotations

import gc
from typing import Dict

import torch

from portbench.yardstick.peaks import power_limit_w


def port_config(model: Dict):
    """The program's ``ModelConfig`` of a configuration's ``model`` block."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    fields = dict(model)
    if fields.get("moe") is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    return ModelConfig(**fields)


def release() -> None:
    """Frees what the dropped program held, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(device) -> Dict:
    """The result's ``device``: platform, the card's name, the cards used,
    the peak of allocated memory, and the card's power limit; a run
    uses one card."""
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                  if device.type == "cuda" else 0)}
    if device.type == "cuda":
        info["power_limit_w"] = power_limit_w()
    return info


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
