"""The ranks of a process group as a mesh with one data-parallel axis, the
counterpart of ``tpuir/parallel/mesh.py``.

tpuir names three axes: ``dp`` (the batch or patch grid), ``sp`` (image
height) and ``tp`` (wide channel dimensions). The port has ``dp``: each
rank, one process on one GPU, takes a contiguous share of a batch
(``batch_sharding``), and ``replicate`` gives every rank rank 0's module
state. ``sp``, ``tp`` and ``shard_params_tp`` are not ported (ROADMAP
Queue 1, "Tensor and spatial parallelism") and raise.

A mesh also holds the group its host gathers take: the default group where
that is gloo, else a gloo group over the same ranks, made when the mesh is
(every rank makes the mesh, as every rank makes a group).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist

from tpuir_torch.parallel.dist import TIMEOUT_S, get_dist_info

NOT_PORTED = ("the {} axis is not ported to tpuir_torch (ROADMAP Queue 1, "
              "\"Tensor and spatial parallelism\"); the port has 'dp' only")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axes`` ({"dp": world size}), this process's ``rank`` and the gloo
    group of its host gathers (None for a process in no group)."""

    axes: Dict[str, int]
    rank: int
    host_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.axes["dp"]


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The process group's ranks on one ``dp`` axis (default
    ``{"dp": world_size}``). As in tpuir, the axes' product must equal the
    world size."""
    rank, world = get_dist_info()
    axes = {"dp": world} if axes is None else dict(axes)
    size = 1
    for n in axes.values():
        size *= n
    if size != world:
        raise ValueError(f"mesh {axes} does not match {world} processes")
    for name in axes:
        if name != "dp":
            raise NotImplementedError(NOT_PORTED.format(repr(name)))
    host_group = None
    if dist.is_available() and dist.is_initialized():
        host_group = (dist.group.WORLD if dist.get_backend() == "gloo" else
                      dist.new_group(backend="gloo",
                                     timeout=datetime.timedelta(seconds=TIMEOUT_S)))
    return Mesh(axes, rank, host_group)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous share of a batch of ``n``, which the ``dp``
    axis must divide (every rank's share the same size, as DDP needs)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} ranks")
    share = n // mesh.size
    return slice(mesh.rank * share, (mesh.rank + 1) * share)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place,
    so that every rank holds rank 0's; returns the module."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def shard_params_tp(*args, **kwargs):
    """tpuir's tensor-parallel placement: not ported."""
    raise NotImplementedError(NOT_PORTED.format("'tp'"))
