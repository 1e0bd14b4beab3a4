"""The paper's experiment models (Sec. 5.2.1), the counterparts of
``repro/models/cnn.py``: the 6-layer MNIST/Fashion-MNIST CNN
``(1,28)C(16,24)M(16,12)C(32,8)M(32,4)`` plus a linear head, and a small
MLP.

Layouts. Images enter ``cnn6_apply`` as the JAX package gives them,
(b, 28, 28, in_ch) NHWC, and are turned to NCHW for
``torch.nn.functional.conv2d``. Conv weights are OIHW (JAX: HWIO), and the
rows of ``fc_w`` follow torch's (c, h, w) flatten of the (b, 32, 4, 4)
feature map (JAX flattens (h, w, c)). ``models.convert.cnn6_from_jax``
and ``cnn6_to_jax`` carry parameters across both ways.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.param import ParamBuilder, build


def cnn6_init(b: ParamBuilder, n_classes: int = 10, in_ch: int = 1):
    """(1,28)C(16,24)M(16,12)C(32,8)M(32,4) + FC head (paper Sec. 5.2.1)."""
    b.param("conv1_w", (16, in_ch, 5, 5), (None, None, None, None), scale=0.1)
    b.param("conv1_b", (16,), (None,), init="zeros")
    b.param("conv2_w", (32, 16, 5, 5), (None, None, None, None),
            scale=0.05)
    b.param("conv2_b", (32,), (None,), init="zeros")
    b.param("fc_w", (32 * 4 * 4, n_classes), (None, None), scale=0.05)
    b.param("fc_b", (n_classes,), (None,), init="zeros")


def cnn6_apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: (b, 28, 28, in_ch) -> logits (b, n_classes)."""
    x = images.permute(0, 3, 1, 2)                    # NHWC -> NCHW
    x = F.relu(F.conv2d(x, params["conv1_w"], params["conv1_b"]))
    x = F.max_pool2d(x, 2)                            # (b, 16, 12, 12)
    x = F.relu(F.conv2d(x, params["conv2_w"], params["conv2_b"]))
    x = F.max_pool2d(x, 2)                            # (b, 32, 4, 4)
    x = x.reshape(x.shape[0], -1)                     # (c, h, w) order
    return x @ params["fc_w"] + params["fc_b"]


def mlp_init(b: ParamBuilder, d_in: int, d_hidden: int, n_classes: int,
             n_hidden_layers: int = 2):
    b.param("w_in", (d_in, d_hidden), (None, None))
    b.param("b_in", (d_hidden,), (None,), init="zeros")
    for i in range(n_hidden_layers - 1):
        b.param(f"w_{i}", (d_hidden, d_hidden), (None, None))
        b.param(f"b_{i}", (d_hidden,), (None,), init="zeros")
    b.param("w_out", (d_hidden, n_classes), (None, None))
    b.param("b_out", (n_classes,), (None,), init="zeros")


def mlp_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ params["w_in"] + params["b_in"])
    i = 0
    while f"w_{i}" in params:
        h = F.relu(h @ params[f"w_{i}"] + params[f"b_{i}"])
        i += 1
    return h @ params["w_out"] + params["b_out"]


def init_cnn6(seed: int = 0, n_classes: int = 10, in_ch: int = 1,
              device=None) -> Dict:
    return build(functools.partial(cnn6_init, n_classes=n_classes,
                                   in_ch=in_ch), seed, torch.float32,
                 resolve_device(device))


def init_mlp(seed: int, d_in: int, d_hidden: int, n_classes: int,
             n_hidden_layers: int = 2, device=None) -> Dict:
    return build(functools.partial(
        mlp_init, d_in=d_in, d_hidden=d_hidden, n_classes=n_classes,
        n_hidden_layers=n_hidden_layers), seed, torch.float32,
        resolve_device(device))


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()
