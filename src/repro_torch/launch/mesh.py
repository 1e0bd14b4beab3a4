"""Device meshes over an initialised ``torch.distributed`` process group,
the counterpart of ``repro/launch/mesh.py``. A JAX ``Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` here, with JAX's dimension
names: the WASGD worker axis is ``("data",)``, or ``("pod", "data")``
across pods (``core/shardmap_agg.py``).

JAX's ``make_production_mesh`` lays TPU pods out as (pod, data, model)
slices of 256 or 512 chips; it has no counterpart: the dry run
(``launch/dryrun.py``) takes the production meshes' shapes alone
(``dryrun.production_mesh``), since it places nothing.
A ``"model"`` dimension holds replicas: as in JAX's Trainer, whose
shard_map specs name only the worker axes, each index on it runs the whole
round of its worker rows (no tensor parallelism).
"""
from __future__ import annotations

import torch.distributed as dist


def make_host_mesh(data: int = 1, model: int = 1):
    """A mesh over the ``data * model`` ranks of the initialised default
    process group, as JAX's ``make_host_mesh`` spans the host's devices:
    ``("data",)`` with ``model`` 1, else ``("data", "model")``; on
    ``cuda`` for an NCCL group, else on ``cpu``. Call it on every rank."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialised process group "
            "(torch.distributed.init_process_group, or torchrun)")
    if data * model != dist.get_world_size():
        raise ValueError(f"make_host_mesh(data={data}, model={model}) over "
                         f"a group of {dist.get_world_size()} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model == 1:
        return init_device_mesh(device_type, (data,),
                                mesh_dim_names=("data",))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
