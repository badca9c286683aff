"""Collectives over a mesh axis's group as autograd Functions: the
collectives XLA inserts for tpuir's ``sp`` and ``tp`` shardings, written
out by hand.

Every function takes the group of one axis (``Mesh.group(axis)``) and is
the identity for no group or a group of one. What differs between them is
the backward, which depends on what the next layer does with the result:

  copy_to       identity; backward all-reduces (sums) over the group. The
                replicated input of a column-parallel layer: each rank's
                gradient holds only its output channels' share.
  reduce_sum    all-reduce of partial sums; backward all-reduces. sp's
                sums over the pixels of the image (the Gram, the L2 norms):
                every rank's loss reads the sum.
  gather_same   all-gather along ``dim``; backward takes this rank's slice
                of the gradient, with no sum. The result is used
                identically on every rank (tp's gathered output channels and
                weights), so each rank's gradient already is the whole one.
  gather_own    all-gather along ``dim``; backward reduce-scatters (sums
                the ranks' gradients, keeps this rank's slice). Each rank
                uses the whole result to compute only its own slice of what
                follows (sp's rows around the MaIR mixer).
  halo_rows     this rank's rows with ``p`` rows of each neighbour along
                ``dim`` (zero rows at the first and last rank, the
                unsharded zero pad); backward sends each halo's gradient
                back to the rank that owns those rows.

The transport is ``all_reduce`` and ``all_gather`` on the group's own
backend, on the tensors where they lie: NCCL across cards, gloo on the CPU
or for several ranks on one card (gloo takes both on CUDA tensors, as
``chip_smoke.py`` phase 22's probe shows, so nothing is copied through the
host here). The halo exchange is an all-gather of the edge rows, since
gloo's send of a CUDA tensor aborts the process; the reduce-scatter is an
all-reduce and a slice, one collective fewer to rely on.

``STATS`` counts each collective call by name and its host ms, the card
synchronised before and after (``reset_stats`` sets them to 0).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

STATS: Dict[str, Dict[str, float]] = {"calls": {}, "ms": {}}


def reset_stats() -> None:
    STATS["calls"].clear()
    STATS["ms"].clear()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(name: str, t: torch.Tensor, fn):
    _sync(t)
    t0 = time.perf_counter()
    out = fn()
    _sync(t)
    STATS["calls"][name] = STATS["calls"].get(name, 0) + 1
    STATS["ms"][name] = STATS["ms"].get(name, 0.0) + (time.perf_counter() - t0) * 1e3
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` is untouched)."""
    out = t.contiguous().clone()
    _timed("all_reduce", out, lambda: dist.all_reduce(out, group=group))
    return out


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (each the same shape), in group rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    _timed("all_gather", t, lambda: dist.all_gather(parts, t, group=group))
    return parts


def _own(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim``, split evenly over ``group``."""
    n = t.shape[dim] // _size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.group), None, None


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        return _own(all_reduce(g, ctx.group), ctx.dim, ctx.group), None, None


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, dim, group):
        ctx.p, ctx.dim, ctx.group = p, dim, group
        i, n = dist.get_rank(group), _size(group)
        edges = all_gather(torch.cat([x.narrow(dim, 0, p),
                                      x.narrow(dim, x.shape[dim] - p, p)], dim), group)
        zeros = torch.zeros_like(x.narrow(dim, 0, p))
        above = edges[i - 1].narrow(dim, p, p) if i > 0 else zeros
        below = edges[i + 1].narrow(dim, 0, p) if i < n - 1 else zeros
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, g):
        p, dim, group = ctx.p, ctx.dim, ctx.group
        i, n = dist.get_rank(group), _size(group)
        rows = g.shape[dim] - 2 * p
        halos = all_gather(torch.cat([g.narrow(dim, 0, p), g.narrow(dim, p + rows, p)], dim),
                           group)
        gx = g.narrow(dim, p, rows).clone()
        if i > 0:  # the rank above read my first rows as its bottom halo
            gx.narrow(dim, 0, p).add_(halos[i - 1].narrow(dim, p, p))
        if i < n - 1:  # the rank below read my last rows as its top halo
            gx.narrow(dim, rows - p, p).add_(halos[i + 1].narrow(dim, 0, p))
        return gx, None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceSum.apply(x, group)


def gather_same(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _GatherSame.apply(x, dim, group)


def gather_own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _GatherOwn.apply(x, dim, group)


def halo_rows(x: torch.Tensor, p: int, dim: int, group: Optional[object]) -> torch.Tensor:
    """``x`` with ``p`` rows of each neighbour along ``dim`` on either side;
    with no group, ``x`` zero-padded by ``p`` rows on either side."""
    if p > x.shape[dim]:
        raise ValueError(f"a halo of {p} rows needs at least {p} rows a rank, "
                         f"got {x.shape[dim]}")
    if _size(group) == 1:
        zeros = torch.zeros_like(x.narrow(dim, 0, p))
        return torch.cat([zeros, x, zeros], dim)
    return _HaloRows.apply(x, p, dim, group)
