"""The mesh the training step runs on: the process group's ranks.

Port of ``repro.launch.mesh``.  Where ``repro`` lays a ``jax`` mesh over
the TPU chips, the port's mesh is the ``torch.distributed`` world, its
ranks in row-major order of the mesh's shape: rank = ((pod x data) +
data) x model + model index.  The ranks that differ only in their model
index form one Tol-FL data group (a federated group) and share its rows
of the batch; over a ``model`` axis > 1 they hold the model's shards
(``repro_torch.sharding``), laid out by the ``DeviceMesh`` that
:attr:`HostMesh.device_mesh` builds on first use.

:func:`init_process_group` reads the ``torchrun`` environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); without it the world is this one process and no
process group is made (every collective over one rank is the identity)
until a ``DeviceMesh`` is asked for, which needs one.  A world that is
already up (the dry-run's fake process group of 256 or 512 ranks) is
used as it is.  NCCL serves CUDA ranks and gloo CPU ones; one card
cannot host two NCCL ranks, so a model axis > 1 on one machine runs on
gloo.
"""
from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import MeshConfig


@dataclass(frozen=True)
class HostMesh:
    """Named axes over the world's ranks, rank order = row-major order
    of ``shape``; this process is ``rank`` and computes on ``device``."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    device: torch.device

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def num_groups(self) -> int:
        """Federated groups = pod x data axis sizes."""
        s = self.sizes
        return s.get("pod", 1) * s.get("data", 1)

    @property
    def model_size(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def group(self) -> int:
        """This rank's global group index: its (pod, data) coordinate."""
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @functools.cached_property
    def device_mesh(self):
        """The ``DeviceMesh`` of the world's ranks in this shape, its dims
        named after the axes.  A world of one rank without a process group
        gets one (an in-memory store)."""
        from torch.distributed.device_mesh import init_device_mesh
        kind = "cuda" if self.device.type == "cuda" else "cpu"
        if not dist.is_initialized():
            dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                    store=dist.HashStore(), rank=0,
                                    world_size=1)
        return init_device_mesh(kind, self.shape,
                                mesh_dim_names=self.axis_names)


def mesh_axis_sizes(mesh: HostMesh) -> Dict[str, int]:
    return mesh.sizes


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group that is up, else of the
    torchrun environment, else (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)))


def init_process_group(device: DeviceLike = None) -> Tuple[int, int,
                                                           torch.device]:
    """Join the torchrun world if there is one (NCCL on the card, gloo on
    the CPU) and return (rank, world size, this rank's device): the card
    ``LOCAL_RANK`` for CUDA ranks."""
    rank, size = world()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and size > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if size > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", rank=rank,
                                world_size=size)
    return rank, size, dev


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               device: DeviceLike) -> HostMesh:
    """A mesh of exactly ``shape``; raises, as ``jax.make_mesh`` does, when
    the world has another number of ranks."""
    rank, size, dev = init_process_group(device)
    if math.prod(shape) != size:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the world has {size}")
    return HostMesh(axes, shape, rank, dev)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> HostMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_mesh_from_config(cfg: MeshConfig, device: DeviceLike = None
                          ) -> HostMesh:
    if cfg.multi_pod:
        return _make_mesh((cfg.pods, cfg.data, cfg.model),
                          ("pod", "data", "model"), device)
    return _make_mesh((cfg.data, cfg.model), ("data", "model"), device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> HostMesh:
    """A (data, model) mesh capped to the ranks there are, as ``repro``
    caps it to the devices: data = min(data, world size)."""
    _, size = world()
    data = min(data, size)
    model = max(1, min(model, size // max(data, 1)))
    return _make_mesh((data, model), ("data", "model"), device)
