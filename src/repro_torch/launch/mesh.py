"""Process groups and device meshes for the distributed steps.

Nothing here runs at import time. :func:`init_host_group` starts a process
group from a file store (no network: each rank passes its rank, the world
size and one shared file path). :func:`make_host_mesh` lays the group's
ranks out as a ``(data, model)`` :class:`~torch.distributed.device_mesh.
DeviceMesh`; the builds and input makers of ``repro_torch.configs`` read
only its dim names and sizes, and the steps of
``repro_torch.distributed`` take its dims' process groups.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("data", "model")


def init_host_group(path: str, rank: int = 0, world_size: int = 1,
                    backend: Optional[str] = None) -> str:
    """``init_process_group`` over the file store at ``path`` (the file
    must not exist before the group's first rank starts). ``backend``
    defaults to ``nccl`` where a CUDA card is present, else ``gloo``.
    Returns the backend."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"file://{path}",
                            rank=rank, world_size=world_size)
    return backend


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the initialised process group's
    first ``data * model`` ranks (``data`` capped at the world size,
    ``model`` at what is left), on the card under ``nccl``, else on the
    CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (init_host_group)")
    n = dist.get_world_size()
    data = min(data, n)
    model = max(min(model, n // data), 1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=MESH_DIMS)


def axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """The number of ranks along ``axes`` (the mesh's dims among them)."""
    n = 1
    for a in axes:
        if a in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def data_axes(mesh: DeviceMesh):
    """The batch-sharding dims: ``("pod", "data")`` where the mesh has them."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
