"""Loss-energy recording (paper Sec. 3.3, Eq. 26 and Alg. 2
``RecordIndex``), a numpy copy of ``repro/core/energy.py``, and the
estimation error of Eq. 27.

``record_mask`` marks which of the tau in-round steps add their losses to
the worker's energy: the last ``m/c`` steps of each of the ``c`` round
segments, so the estimate is spread over the round and costs no extra
forward pass.
"""
from __future__ import annotations

import numpy as np
import torch


def record_indices(tau: int, m: int, c: int) -> np.ndarray:
    """Alg. 2 Function 1: indices ((i+1)*tau/c - j - 1) for j < m/c, i < c."""
    c = max(1, min(c, tau))
    per_chunk = max(1, min(m // c if m >= c else 1, tau // c))
    out = set()
    for i in range(c):
        end = (i + 1) * tau // c
        for j in range(per_chunk):
            idx = end - j - 1
            if 0 <= idx < tau:
                out.add(idx)
    return np.asarray(sorted(out), dtype=np.int32)


def record_mask(tau: int, m: int, c: int) -> np.ndarray:
    """(tau,) bool: True where step t records its losses."""
    mask = np.zeros((tau,), bool)
    mask[record_indices(tau, m, c)] = True
    return mask


def estimation_error(theta, theta_true) -> torch.Tensor:
    """Eq. 27: sum_i |theta_i - theta_true_i|, in [0, 2] for two weight
    vectors (tensors or arrays; a 0-d tensor)."""
    return (torch.as_tensor(theta) - torch.as_tensor(theta_true)).abs().sum()
