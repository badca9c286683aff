"""The ranks of a process group as tpuir's mesh, the counterpart of
``tpuir/parallel/mesh.py``.

tpuir names three axes: ``dp`` (the batch or the patch grid), ``sp`` (image
height) and ``tp`` (wide channel dimensions). ``make_mesh`` takes any of
them, in the order given, and lays the ranks out row-major over them, as
tpuir's ``reshape`` lays out its devices: the last axis varies fastest.
Each rank, one process on one GPU, holds its coordinate on every axis and
a group per axis (the ranks that differ from it on that axis alone), and
the ``dp x sp`` group over which gradients are averaged (the ranks that
share its ``tp`` coordinate). ``batch_sharding`` gives a rank its share of
a batch over ``dp`` and of the height over ``sp``; ``replicate`` gives
every rank rank 0's module state. The collectives that XLA inserts for
``sp`` and ``tp`` are ``collectives.py``'s; the layers that call them are
``spatial.py``'s and ``tensor.py``'s (``shard_params_tp``).

A mesh also holds the gloo group its host gathers take, along ``dp``: the
group along ``dp`` where the default backend is gloo, else a gloo group over
the same ranks (none for a ``dp`` of one). Every rank makes the mesh, since
every rank makes every group, in the same order.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from tpuir_torch.parallel.dist import TIMEOUT_S, get_dist_info

AXES = ("dp", "sp", "tp")
GRAD_AXES = ("dp", "sp")  # the ranks that average a gradient


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axes`` ({name: size}, in layout order), this process's ``rank``, the
    gloo group along ``dp`` of its host gathers, its group along each axis
    (``groups``; none for an axis of one) and its ``dp x sp`` group
    (``grad_group``). A process in no group has none of them."""

    axes: Dict[str, int]
    rank: int
    host_group: Optional[object] = None
    groups: Mapping[str, object] = dataclasses.field(default_factory=dict)
    grad_group: Optional[object] = None

    def shape(self, axis: str) -> int:
        """The size of ``axis`` (1 for an axis the mesh does not name)."""
        return self.axes.get(axis, 1)

    @property
    def world(self) -> int:
        return volume(self.axes)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (row-major: the last axis
        varies fastest)."""
        return coords_of(self.axes, self.rank)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def ranks_over(self, axes: Sequence[str]) -> List[int]:
        """The ranks that differ from this one on ``axes`` only, in layout
        order (this rank's coordinates on the other axes)."""
        return ranks_over(self.axes, self.coords, axes)


def volume(axes: Mapping[str, int]) -> int:
    n = 1
    for size in axes.values():
        n *= size
    return n


def coords_of(axes: Mapping[str, int], rank: int) -> Dict[str, int]:
    out = {}
    for name in reversed(list(axes)):
        rank, out[name] = divmod(rank, axes[name])
    return {name: out[name] for name in axes}


def ranks_over(axes: Mapping[str, int], coords: Mapping[str, int],
               over: Sequence[str]) -> List[int]:
    names = list(axes)
    ranks = []
    for values in itertools.product(*(range(axes[a]) if a in over else (coords[a],)
                                      for a in names)):
        r = 0
        for name, v in zip(names, values):
            r = r * axes[name] + v
        ranks.append(r)
    return sorted(ranks)


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The process group's ranks on ``axes`` (default ``{"dp": world
    size}``) of ``dp``, ``sp`` and ``tp``. As in tpuir, the axes' product
    must equal the world size."""
    rank, world = get_dist_info()
    axes = {"dp": world} if axes is None else dict(axes)
    unknown = [name for name in axes if name not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}: the axes are {AXES}")
    if volume(axes) != world:
        raise ValueError(f"mesh {axes} does not match {world} processes")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axes, rank)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    groups = {name: _new_groups(axes, (name,), rank, timeout)
              for name in axes if axes[name] > 1}
    host_group = groups.get("dp")
    if host_group is not None and dist.get_backend() != "gloo":
        host_group = _new_groups(axes, ("dp",), rank, timeout, backend="gloo")
    grad = tuple(a for a in GRAD_AXES if axes.get(a, 1) > 1)
    grad_group = (groups[grad[0]] if len(grad) == 1 else
                  _new_groups(axes, grad, rank, timeout) if grad else None)
    return Mesh(axes, rank, host_group, groups, grad_group)


def _new_groups(axes: Mapping[str, int], over: Sequence[str], rank: int, timeout,
                backend: Optional[str] = None):
    """Make every group of ranks that differ on ``over`` only (every rank
    makes all of them, in one order; on ``backend``, default the default
    group's); return this rank's."""
    mine = None
    for r in range(volume(axes)):
        ranks = ranks_over(axes, coords_of(axes, r), over)
        if ranks[0] == r:  # each group once, at its first rank
            group = dist.new_group(ranks, timeout=timeout, backend=backend)
            if rank in ranks:
                mine = group
    return mine


def batch_sharding(mesh: Mesh, n: int, h: Optional[int] = None
                   ) -> Union[slice, Tuple[slice, slice]]:
    """This rank's contiguous share of a batch of ``n`` over ``dp`` (every
    rank's share the same size, as DDP needs) and, with ``h``, its rows of
    an image of height ``h`` over ``sp`` (tpuir's ``spatial_axis``):
    ``x[batch_sharding(mesh, n, h)]`` of an NHWC array. Raises unless the
    splits are even."""
    dp = mesh.shape("dp")
    if n % dp:
        raise ValueError(f"a batch of {n} does not split over {dp} ranks")
    share, i = n // dp, mesh.coord("dp")
    rows = slice(i * share, (i + 1) * share)
    if h is None:
        return rows
    sp = mesh.shape("sp")
    if h % sp:
        raise ValueError(f"a height of {h} does not split over {sp} ranks")
    part, j = h // sp, mesh.coord("sp")
    return rows, slice(j * part, (j + 1) * part)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers, in place, within the
    ranks that hold a replica of each: every rank for a whole tensor (from
    rank 0), the ``dp x sp`` group for a ``tp`` shard (from its first
    rank). Returns the module."""
    if mesh.world > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                if getattr(t, "tp_shard", None) is None:
                    dist.broadcast(t.data, src=0)
                elif mesh.grad_group is not None:
                    dist.broadcast(t.data, src=mesh.ranks_over(GRAD_AXES)[0],
                                   group=mesh.grad_group)
    return module
