"""A whole chunked SSD forward around the ``ssd_chunk`` kernel, the
counterpart of ``repro/kernels/ssd_chunk/ops.py:20``
(``ssd_chunked_kernel``): a drop-in for ``models.ssm.ssd_chunked``.

The kernel computes the within-chunk blocks through its
``autograd.Function`` (``SSDChunkFunction``: the training forward launches
it, and ``vmap`` over workers makes one launch); the inter-chunk
recurrence (one (nh, ds, hd) update per chunk) and the ``C S_prev`` term
stay plain torch ops, as they stay plain JAX there, and autograd takes
them as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_chunk.ssd_chunk import SSDChunkFunction


def ssd_chunked_kernel(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (b, s, nh, hd); dt (b, s, nh); a (nh,) negative; B, C (b, s, ds);
    s a multiple of ``chunk``. Returns (y (b, s, nh, hd), final_state
    (b, nh, ds, hd)), both float32."""
    b, s, nh, hd = xs.shape
    ds = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xs_c = xs.reshape(b, nc, chunk, nh, hd).contiguous()
    dt_c = dt.float().reshape(b, nc, chunk, nh).contiguous()
    B_c = B.reshape(b, nc, chunk, ds).contiguous()
    C_c = C.reshape(b, nc, chunk, ds).contiguous()

    y_diag, states, totals = SSDChunkFunction.apply(
        xs_c, dt_c, a.float().contiguous(), B_c, C_c)

    prev = (torch.zeros((b, nh, ds, hd), dtype=torch.float32,
                        device=xs.device)
            if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = torch.exp(totals[:, c])[:, :, None, None] * prev + states[:, c]
    prevs = torch.stack(prevs, dim=1)                 # (b, nc, nh, ds, hd)

    cum = torch.cumsum(dt_c * a.float(), dim=2)
    y_off = torch.einsum("bnls,bnhsd,bnlh->bnlhd", C_c.float(), prevs,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, s, nh, hd), prev
