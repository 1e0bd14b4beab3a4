"""Explicit collectives for the WASGD communication step over a
``torch.distributed`` device mesh, the counterpart of
``repro/core/shardmap_agg.py``: the *phase* primitives behind the mesh
schedules (``shard_map``, ``rs_ag``) of ``core/backends.py``.

JAX's ``shard_map`` runs a per-shard program with explicit collectives.
Here each rank is one shard: it holds the rows of the worker dimension
that its shard owns. Over a ``("data",)`` mesh of S ranks (or a
``("pod", "data")`` mesh, row-major over pod and then data, the layout of
``P(("pod", "data"))``) shard ``r`` holds worker rows
``[r * w / S, (r + 1) * w / S)`` of every worker-stacked leaf; theta, the
Alg. 4 mask and the loss energies are the full ``(w,)`` vectors, the same
on every rank.

    all_reduce_m_phase   m = all_reduce(theta_local . payload_local)
    reduce_scatter_phase slice = reduce_scatter(theta-reduced local
                         partial), the partial in a wire dtype
    all_gather_phase     m = all_gather(slice)

Each phase returns the *aggregate* (or this rank's slice of it); the
worker-local FMA ``(1 - beta) x + beta m`` and the late-join mask are the
schedule's ``finalize``. ``reduce_scatter_phase`` can issue its collective
asynchronously (``async_op=True``) and ``all_gather_phase`` then waits on
it first: the ``overlap=`` thunk runs between the two.

Three more moves of rows serve the rest of the trainer under a mesh:
``broadcast_row`` (MWU's argmax worker, from the rank that holds it),
``gather_rows_to`` (a checkpoint shard's rows, to the rank that writes
it) and ``move_rows`` (a membership resize: the survivors' rows point to
point to the rank that holds them after it).

A mesh axis other than ``"pod"``/``"data"`` (JAX's ``"model"``) must have
size 1: model parallelism is not ported (ROADMAP.md queue 1.11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.aggregate import fma_late_join, is_worker_leaf
from repro_torch.tree import tree_map

WORKER_AXES = ("pod", "data")
MODEL_AXIS_NOT_PORTED = ("a mesh axis other than 'pod'/'data' of size > 1 "
                         "(model or expert parallelism) is not ported "
                         "(ROADMAP.md queue 1.11)")


def _worker_axes_in(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in WORKER_AXES if a in names)


def check_mesh(mesh) -> None:
    """Raises unless the mesh's every axis of size > 1 is a worker axis."""
    names = mesh.mesh_dim_names
    if not names or not _worker_axes_in(mesh):
        raise ValueError(f"a WASGD mesh names its worker axes {WORKER_AXES} "
                         f"(got mesh_dim_names={names})")
    for i, a in enumerate(names):
        if a not in WORKER_AXES and mesh.mesh.shape[i] > 1:
            raise NotImplementedError(f"mesh axis {a!r} of size "
                                      f"{mesh.mesh.shape[i]}: "
                                      f"{MODEL_AXIS_NOT_PORTED}")


def mesh_worker_shards(mesh) -> int:
    """Number of shards the worker dim is split over (S)."""
    s = 1
    for a in _worker_axes_in(mesh):
        s *= mesh.mesh.shape[mesh.mesh_dim_names.index(a)]
    return s


def worker_group(mesh):
    """The process group over the worker axes, whose rank order is the
    shards' row-major order. With both ``pod`` and ``data`` that group
    is the whole mesh, which must then be the default group's ranks in
    order (as ``init_device_mesh`` lays them out)."""
    check_mesh(mesh)
    axes = _worker_axes_in(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise NotImplementedError(
            "a ('pod', 'data') mesh over a subset or a permutation of the "
            "default group's ranks; build it with init_device_mesh over "
            "every rank")
    return dist.group.WORLD


def shard_index(mesh) -> int:
    """This rank's shard: its row-major coordinate over the worker axes."""
    return dist.get_rank(worker_group(mesh))


def local_workers(w: int, mesh) -> int:
    """How many of ``w`` workers each shard holds (``w`` without a
    mesh)."""
    if mesh is None:
        return w
    s = mesh_worker_shards(mesh)
    if w % s:
        raise ValueError(f"{w} workers do not split over {s} mesh shards: "
                         f"under a mesh the worker count must be a "
                         f"multiple of {s}")
    return w // s


def local_rows(w: int, mesh) -> slice:
    """The worker rows of a ``(w, ...)`` leaf that this rank's shard
    owns."""
    n = local_workers(w, mesh)
    r = shard_index(mesh)
    return slice(r * n, (r + 1) * n)


def local_theta(theta: torch.Tensor, n_local: int, mesh) -> torch.Tensor:
    """This shard's rows of the full ``(w,)`` theta (or mask), checked
    against the ``n_local`` worker rows that the shard holds."""
    s = mesh_worker_shards(mesh)
    if theta.shape[0] != n_local * s:
        raise ValueError(
            f"under a mesh a worker leaf holds this shard's rows: "
            f"{n_local} rows x {s} shards != {theta.shape[0]} workers of "
            f"theta")
    return theta[local_rows(theta.shape[0], mesh)]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every shard's rows of a worker-stacked tensor, in worker order:
    ``(w / S, ...)`` on each rank -> ``(w, ...)`` on every rank."""
    s = mesh_worker_shards(mesh)
    x = x.contiguous()
    out = torch.empty((x.shape[0] * s,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=worker_group(mesh))
    return out


def all_reduce_(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over the worker group (a scalar too)."""
    dist.all_reduce(x, op=op, group=worker_group(mesh))
    return x


def _global_rank(mesh, shard: int) -> int:
    return dist.get_global_rank(worker_group(mesh), shard)


def broadcast_row(x: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """Worker ``k``'s row of a worker-stacked tensor (this shard's rows),
    in float32 on every rank: broadcast from the rank that holds it."""
    n = x.shape[0]
    owner = k // n
    if shard_index(mesh) == owner:
        row = x[k - owner * n].float().contiguous()
    else:
        row = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    dist.broadcast(row, src=_global_rank(mesh, owner),
                   group=worker_group(mesh))
    return row


def gather_rows_to(x: torch.Tensor, owner: int, mesh) -> Optional[
        torch.Tensor]:
    """Every shard's rows of a worker-stacked tensor, in worker order, on
    shard ``owner`` only (``(w, ...)``; None on the other ranks)."""
    x = x.contiguous()
    out = parts = None
    if shard_index(mesh) == owner:
        out = torch.empty((x.shape[0] * mesh_worker_shards(mesh),)
                          + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        parts = list(out.chunk(mesh_worker_shards(mesh)))
    dist.gather(x, gather_list=parts, dst=_global_rank(mesh, owner),
                group=worker_group(mesh))
    return out


def move_rows(x: torch.Tensor, new_p: int, mesh,
              fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A membership resize of a worker-stacked tensor under the mesh:
    ``x`` holds this shard's rows of ``old_p = x.shape[0] * S`` workers,
    the result its rows of ``new_p``. Worker ``i < min(old_p, new_p)``
    keeps its row bitwise; where its shard changes, the row goes point to
    point from the old shard's rank to the new one's. Workers ``i >=
    old_p`` take ``fill`` (one row, the same on every rank; None: zeros).
    Every rank holds its old and new rows only."""
    s = mesh_worker_shards(mesh)
    r = shard_index(mesh)
    n, n2 = x.shape[0], local_workers(new_p, mesh)
    survivors = min(n * s, new_p)
    out = x.new_zeros((n2,) + tuple(x.shape[1:]))
    ops = []
    for src in range(s):
        for dst in range(s):
            lo = max(src * n, dst * n2)
            hi = min((src + 1) * n, (dst + 1) * n2, survivors)
            if lo >= hi or r not in (src, dst):
                continue
            if src == dst:
                out[lo - r * n2:hi - r * n2] = x[lo - r * n:hi - r * n]
            elif src == r:
                ops.append(dist.P2POp(
                    dist.isend, x[lo - r * n:hi - r * n].contiguous(),
                    _global_rank(mesh, dst), worker_group(mesh)))
            else:
                ops.append(dist.P2POp(dist.irecv, out[lo - r * n2:hi - r * n2],
                                      _global_rank(mesh, src),
                                      worker_group(mesh)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if fill is not None:
        lo = max(n * s, r * n2)
        if lo < (r + 1) * n2:
            out[lo - r * n2:] = fill.to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# Phase primitives
# ---------------------------------------------------------------------------

def all_reduce_m_phase(payload: torch.Tensor, theta: torch.Tensor, mesh,
                       reduce_dtype=torch.float32) -> torch.Tensor:
    """One-phase schedule: this shard's ``(w/S, ...)`` payload -> the
    float32 aggregate ``m = sum_j theta_j payload_j`` of shape
    ``payload.shape[1:]``, the same on every rank. The theta-weighted
    local sum and the all-reduce run in ``reduce_dtype``."""
    t = local_theta(theta, payload.shape[0], mesh).to(reduce_dtype)
    contrib = (t.reshape(t.shape + (1,) * (payload.dim() - 1))
               * payload.to(reduce_dtype)).sum(dim=0)
    all_reduce_(contrib, mesh)
    return contrib.float()


def reduce_scatter_phase(payload: torch.Tensor, theta: torch.Tensor, mesh,
                         wire_dtype=torch.float32, async_op: bool = False):
    """rs_ag phase 1: this shard's ``(w/S, n_pad)`` payload -> its
    ``(n_pad / S,)`` slice of the theta-reduced aggregate. The local
    copies are theta-reduced *before* the scatter (with w/S > 1,
    scattering the concatenated copies would hand each shard a chunk of
    the wrong copy), and the partial rides in ``wire_dtype``. With
    ``async_op`` returns ``(slice, work)``: the collective is in flight
    until ``all_gather_phase`` waits on ``work``."""
    t = local_theta(theta, payload.shape[0], mesh).float()
    contrib = (t[:, None] * payload.float()).sum(dim=0).to(wire_dtype)
    s = mesh_worker_shards(mesh)
    out = torch.empty(contrib.shape[0] // s, dtype=wire_dtype,
                      device=contrib.device)
    work = dist.reduce_scatter_tensor(out, contrib,
                                      group=worker_group(mesh),
                                      async_op=async_op)
    return (out, work) if async_op else out


def all_gather_phase(m_scat: torch.Tensor, mesh, work=None) -> torch.Tensor:
    """rs_ag phase 2: the scattered ``(n_pad / S,)`` slices -> the float32
    aggregate, the same on every rank. ``work``: the reduce-scatter's
    handle, waited on first."""
    if work is not None:
        work.wait()
    return gather_rows(m_scat, mesh).float()


def flatten_pad(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, int]:
    """``(w, ...)`` leaf -> ``((w, n_pad), n)``: the trailing dims
    flattened and zero-padded so the scatter divides over ``p`` shards."""
    n = 1
    for s in x.shape[1:]:
        n *= s
    flat = x.reshape(x.shape[0], n)
    pad = (-n) % p
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, n


def local_active(active: Optional[torch.Tensor], n_local: int, mesh):
    """This shard's rows of the full ``(w,)`` Alg. 4 mask (None: none)."""
    return None if active is None else local_theta(active, n_local, mesh)


# ---------------------------------------------------------------------------
# Fused entries (compositions of the phases above)
# ---------------------------------------------------------------------------

def aggregate_leaf_shard_map(x: torch.Tensor, theta: torch.Tensor, beta,
                             mesh, active: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """This shard's rows of one leaf through the all-reduce schedule;
    ``active`` is the full ``(w,)`` late-join mask (None: all active)."""
    m = all_reduce_m_phase(x, theta, mesh)
    return fma_late_join(x, m, beta, local_active(active, x.shape[0], mesh))


def aggregate_leaf_rs_ag(x: torch.Tensor, theta: torch.Tensor, beta, mesh,
                         comm_dtype=torch.float32,
                         active: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Reduce-scatter + all-gather + local FMA of Eq. 10 for this shard's
    rows of one leaf, the ring partial in ``comm_dtype``."""
    flat, n = flatten_pad(x, mesh_worker_shards(mesh))
    m = all_gather_phase(reduce_scatter_phase(flat, theta, mesh,
                                              wire_dtype=comm_dtype), mesh)
    out = fma_late_join(flat, m, beta, local_active(active, x.shape[0], mesh))
    return out[:, :n].reshape(x.shape)


def weighted_aggregate_shard_map(params: Dict, axes: Dict,
                                 theta: torch.Tensor, beta, mesh,
                                 schedule: str = "all_reduce",
                                 comm_dtype=torch.float32) -> Dict:
    """Eq. 10 on every worker leaf (this shard's rows) through
    ``schedule`` ``"all_reduce"`` or ``"rs_ag"`` (the ring partial in
    ``comm_dtype``)."""
    if schedule == "all_reduce":
        def leaf(x):
            return aggregate_leaf_shard_map(x, theta, beta, mesh)
    else:
        def leaf(x):
            return aggregate_leaf_rs_ag(x, theta, beta, mesh,
                                        comm_dtype=comm_dtype)
    return tree_map(lambda x, ax: leaf(x) if is_worker_leaf(ax) else x,
                    params, axes)
