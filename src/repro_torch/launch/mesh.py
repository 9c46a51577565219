"""Process groups and device meshes for the distributed steps.

Nothing here runs at import time. :func:`init_host_group` starts a process
group from a file store (no network: each rank passes its rank, the world
size and one shared file path). :func:`make_host_mesh` lays the group's
ranks out as a ``(data, model)`` :class:`~torch.distributed.device_mesh.
DeviceMesh`; the builds and input makers of ``repro_torch.configs`` read
only its dim names and sizes, and the steps of
``repro_torch.distributed`` take its dims' process groups.

:func:`make_production_mesh` is the reference's: ``(16, 16)`` ``("data",
"model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")``. Only the dry
run builds it, over the placeholder ranks of :func:`init_placeholder_group`
(the ``fake`` backend: every collective returns at once, nothing moves),
the counterpart of the reference's 512 forced host devices. The H100
constants below are the roofline's (datasheet figures, none measured here).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("data", "model")
POD_MESH_DIMS = ("pod", "data", "model")

# NVIDIA H100 SXM5 80GB (700 W) datasheet figures for the dry run's roofline
CHIP_PEAK_FLOPS = 989.4e12       # dense bf16 FLOP/s
CHIP_PEAK_FLOPS_F32 = 66.9e12    # float32 FLOP/s (the port keeps TF32 off)
CHIP_HBM_BW = 3.35e12            # HBM3 bytes/s
NVLINK_BW = 450e9                # NVLink 4, bytes/s a direction, within a node
NIC_BW = 50e9                    # one 400 Gb/s NIC a GPU between nodes (DGX H100)
GPUS_PER_NODE = 8


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


def init_placeholder_group(world_size: int) -> None:
    """Start the ``fake`` backend as rank 0 of ``world_size`` placeholder
    ranks (the dry run's counterpart of the reference's
    ``--xla_force_host_platform_device_count``): its collectives return at
    once and move nothing. Refuses to run when a process group exists."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "placeholder group needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: Tuple[int, ...], device_type: str = "cuda"
              ) -> DeviceMesh:
    """A mesh of ``shape`` over the initialised group's first ranks,
    row-major: ``("data", "model")`` for two dims, ``("pod", "data",
    "model")`` for three."""
    names = {2: MESH_DIMS, 3: POD_MESH_DIMS}[len(shape)]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(f"a mesh of {shape} needs an initialised process "
                           f"group of at least {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh over the initialised process group
    (256 ranks, or 512 with ``multi_pod``; anything else raises): ``(16,
    16)`` ``("data", "model")`` or ``(2, 16, 16)`` ``("pod", "data",
    "model")``. The ranks lie row-major, 8 to a node (:data:`GPUS_PER_NODE`),
    so a ``"model"`` group is two nodes and a ``"data"`` or ``"pod"`` group
    one rank of each of 16 or 2 nodes: on both meshes every dim's groups
    cross nodes, and :func:`link_bandwidth` prices each at the NIC's
    rate."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    want = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != want:
        got = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {want} ranks, not {got}")
    return make_mesh(shape, device_type)


def link_bandwidth(mesh: DeviceMesh, dim: str) -> float:
    """Bytes/s a rank sends along ``dim``: :data:`NVLINK_BW` when each of
    the dim's groups lies within one node of :data:`GPUS_PER_NODE` ranks,
    else :data:`NIC_BW`."""
    ranks = mesh.mesh.movedim(mesh.mesh_dim_names.index(dim), -1)
    nodes = ranks.reshape(-1, ranks.shape[-1]) // GPUS_PER_NODE
    return NVLINK_BW if bool((nodes == nodes[:, :1]).all()) else NIC_BW
