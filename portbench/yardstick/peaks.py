"""Data-sheet peaks of one NVIDIA H100 SXM (dense, no sparsity, at the
700 W limit), frozen here so that a change to the program cannot move
the yardstick. ``card()`` reads the card's name and power limit, which
every result carries beside the numbers measured against these peaks."""
from __future__ import annotations

import subprocess

BF16_FLOP_PER_S = 989e12        # bf16/fp16 on the tensor cores
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3
HBM_BYTES = 80e9


def bound_s(bytes_moved: float, flops: float = 0.0,
            flop_rate: float = BF16_FLOP_PER_S) -> float:
    """The least time the card could take for the work: the larger of
    its bytes over the bandwidth and its operations over the rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / flop_rate)


def power_limit_w() -> str:
    """The card's ``power.limit`` as ``nvidia-smi`` reads it, or
    ``"unknown"`` where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else "unknown"
