"""Process groups and meshes for the mesh engine (``repro.launch.mesh``).

The port runs one process a GPU. :func:`init_distributed` brings up the
default process group: from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) when it is
set, else a world of one over an in-memory ``HashStore`` (no port is
opened; the reference's default mesh on a one-device host is one shard
too). NCCL on CUDA, gloo on the CPU; every collective times out after
``TIMEOUT`` rather than hang. On CUDA it pins ``LOCAL_RANK``'s device.

:func:`make_local_mesh` is the world's ranks as a ``("data", "model")``
``DeviceMesh`` with ``model`` of size 1, the reference's local mesh, and
:func:`local_mesh` the one the mesh engine takes when none is installed.
Each of the three brings the process group up on a GPU unless it is asked
for the CPU (``device="cpu"``): without a GPU the default raises.

:func:`make_production_mesh` is the reference's pod mesh, 256 cards as
``(16, 16)`` ``("data", "model")`` or 512 as ``(2, 16, 16)`` ``("pod",
"data", "model")``. One machine cannot bring up a process group that size,
so it is an :class:`AbstractMesh`: the shape and names that the planner
(:mod:`repro_torch.launch.dryrun`) and ``dist.sharding.param_shardings``
read, and no process group.

Run the mesh engine on N GPUs with ``torchrun --nproc-per-node N -m
repro_torch.launch.decompose --engine mesh ...``, or on the CPU over gloo
with ``--device cpu``.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

__all__ = ["TIMEOUT", "AbstractMesh", "init_distributed", "local_mesh", "make_local_mesh",
           "make_production_mesh", "shutdown"]

TIMEOUT = datetime.timedelta(seconds=60)   # a hung collective fails after this


class _LocalMesh:
    """The mesh :func:`local_mesh` hands out, made once a default process
    group: making a mesh makes process groups (NCCL communicators)."""

    def __init__(self):
        self.group = None
        self.mesh = None


_LOCAL = _LocalMesh()


def init_distributed(device="cuda", *, timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Bring up the default process group if it is not up, and return this
    rank's device: ``cuda:LOCAL_RANK`` (made current) for a CUDA
    ``device``, the CPU for ``"cpu"``. ``device`` is resolved by
    :func:`repro_torch.device.resolve_device`: the default, CUDA, raises
    without a GPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
    return device


def make_local_mesh(device="cuda") -> DeviceMesh:
    """The world's ranks as a ``("data", "model")`` mesh with ``model`` 1
    (bringing the process group up first if it is not up)."""
    device = init_distributed(device)
    return init_device_mesh(device.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def local_mesh(device="cuda") -> DeviceMesh:
    """:func:`make_local_mesh`, made once while the default process group
    lives: the mesh engine's default mesh."""
    init_distributed(device)
    if _LOCAL.mesh is None or _LOCAL.group is not dist.group.WORLD:
        _LOCAL.mesh = make_local_mesh(device)
        _LOCAL.group = dist.group.WORLD
    return _LOCAL.mesh


class AbstractMesh:
    """A mesh's shape and dimension names with no process group behind it:
    what ``DeviceMesh`` offers the planner (``shape``, ``mesh_dim_names``,
    ``size()``)."""

    def __init__(self, shape, mesh_dim_names):
        if len(shape) != len(mesh_dim_names):
            raise ValueError(f"shape {shape} and names {mesh_dim_names} differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(mesh_dim_names)

    def size(self, mesh_dim=None) -> int:
        if mesh_dim is None:
            return math.prod(self.shape)
        if isinstance(mesh_dim, str):
            mesh_dim = self.mesh_dim_names.index(mesh_dim)
        return self.shape[mesh_dim]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The 16x16 single pod (256 cards) or the 2x16x16 two-pod mesh (512)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def shutdown() -> None:
    """Drop the mesh engine's kept chunks (their graphs hold the groups'
    collectives) and destroy the default process group."""
    from repro_torch.core import engine

    engine.clear_chunk_cache()
    _LOCAL.mesh = _LOCAL.group = None
    if dist.is_initialized():
        dist.destroy_process_group()
