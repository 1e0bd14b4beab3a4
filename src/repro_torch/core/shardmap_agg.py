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

A mesh axis other than ``"pod"``/``"data"`` (JAX's ``"model"``) holds
replicas: JAX's specs name only the worker axes, so each worker row is
replicated over the others, and each index on them runs the round of the
worker axes alone. The worker group of a rank is the ranks that share its
coordinates on every other axis, its shards in the row-major order of
the worker coordinates; the mesh may lay any ranks out in any order
(``_Group``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.aggregate import fma_late_join, is_worker_leaf
from repro_torch.tree import tree_map

WORKER_AXES = ("pod", "data")


class _Group(NamedTuple):
    """The ranks that share this rank's coordinates on every axis but
    ``axes``. ``ranks``: their global ranks in the row-major order of their
    coordinates on ``axes`` (the shard order); ``index``: this rank's
    position there; ``to_group[s]``: the process-group rank of position
    ``s`` (a group orders its ranks by their global rank), None where the
    two orders agree."""
    group: object
    ranks: Tuple[int, ...]
    index: int
    to_group: Optional[Tuple[int, ...]]


def _worker_axes_in(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in WORKER_AXES if a in names)


def _other_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a not in WORKER_AXES)


def check_mesh(mesh) -> None:
    """Raises unless the mesh names a worker axis."""
    names = mesh.mesh_dim_names
    if not names or not _worker_axes_in(mesh):
        raise ValueError(f"a WASGD mesh names its worker axes {WORKER_AXES} "
                         f"(got mesh_dim_names={names})")


def _group_over(mesh, axes: Tuple[str, ...]) -> _Group:
    """This rank's ``_Group`` over ``axes``, made once per mesh and cached
    on it. One axis: the mesh's own group of that dimension. Every rank of
    the default group over ``axes``: the default group. Otherwise every
    such group of the mesh is made with ``dist.new_group``, by every rank
    of the default group in the same order (the first call is then
    collective over the default group, ranks outside the mesh included)."""
    cache = mesh.__dict__.setdefault("_wasgd_groups", {})
    if axes in cache:
        return cache[axes]
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    rows = mesh.mesh.permute(rest + dims).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in dims)).tolist()
    me = dist.get_rank()
    mine = next((row for row in rows if me in row), None)
    if len(axes) == 1:
        group = mesh.get_group(axes[0]) if mine is not None else None
    elif len(rows) == 1 and sorted(mine or ()) == list(
            range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        group = None
        for row in rows:
            g = dist.new_group(row)
            if row is mine:
                group = g
    out = _Group(None, (), -1, None)
    if mine is not None:
        order = sorted(mine)
        to_group = tuple(order.index(r) for r in mine)
        out = _Group(group, tuple(mine), mine.index(me),
                     None if to_group == tuple(range(len(mine)))
                     else to_group)
    cache[axes] = out
    return out


def _worker(mesh) -> _Group:
    check_mesh(mesh)
    g = _group_over(mesh, _worker_axes_in(mesh))
    if g.group is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return g


def mesh_worker_shards(mesh) -> int:
    """Number of shards the worker dim is split over (S)."""
    s = 1
    for a in _worker_axes_in(mesh):
        s *= mesh.mesh.shape[mesh.mesh_dim_names.index(a)]
    return s


def worker_group(mesh):
    """The process group of this rank's worker shards: the ranks that
    share its coordinates on every axis other than ``pod``/``data``. None
    on a rank outside the mesh, whose call still takes its part in making
    the mesh's groups (``_group_over``)."""
    check_mesh(mesh)
    return _group_over(mesh, _worker_axes_in(mesh)).group


def replica_index(mesh) -> int:
    """This rank's row-major coordinate over the mesh's other axes (JAX's
    ``"model"``): 0 on the replica that writes a checkpoint."""
    other = _other_axes(mesh)
    return _group_over(mesh, other).index if other else 0


def replica_group(mesh):
    """The process group of the ranks that hold this rank's worker rows
    (its coordinates on the worker axes, any on the others); None where
    the other axes are all of size 1."""
    if mesh.mesh.numel() == mesh_worker_shards(mesh):
        return None
    return _group_over(mesh, _other_axes(mesh)).group


def shard_index(mesh) -> int:
    """This rank's shard: its row-major coordinate over the worker axes."""
    return _worker(mesh).index


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
    g = _worker(mesh)
    s = len(g.ranks)
    x = x.contiguous()
    out = torch.empty((x.shape[0] * s,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=g.group)
    if g.to_group is None:
        return out
    # the group's order to the shards'
    return out.reshape((s, -1) + tuple(x.shape[1:]))[list(g.to_group)] \
        .reshape(out.shape)


def all_reduce_(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over the worker group (a scalar too)."""
    dist.all_reduce(x, op=op, group=worker_group(mesh))
    return x


def _global_rank(mesh, shard: int) -> int:
    return _worker(mesh).ranks[shard]


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
    g = _worker(mesh)
    s = len(g.ranks)
    x = x.contiguous()
    out = parts = None
    if g.index == owner:
        out = torch.empty((x.shape[0] * s,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        parts = list(out.chunk(s))
        if g.to_group is not None:       # the list is in the group's order
            parts = [parts[g.to_group.index(k)] for k in range(s)]
    dist.gather(x, gather_list=parts, dst=g.ranks[owner], group=g.group)
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
    g = _worker(mesh)
    s = len(g.ranks)
    if g.to_group is not None:     # group rank j receives chunk j
        contrib = contrib.reshape(s, -1)[
            [g.to_group.index(j) for j in range(s)]].reshape(-1)
    out = torch.empty(contrib.shape[0] // s, dtype=wire_dtype,
                      device=contrib.device)
    work = dist.reduce_scatter_tensor(out, contrib, group=g.group,
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
