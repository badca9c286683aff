"""The train step on a mesh of ``dp``, ``sp`` and ``tp``: tpuir's
``make_train_step`` (``tpuir/train/trainer.py``) under its shardings, with
the gradient reductions XLA inserts written out.

Each rank holds its share of the batch over ``dp`` and of the rows over
``sp`` (``mesh.batch_sharding``), runs the model split by
``parallelize_spatial`` and ``shard_params_tp``, and takes the mean loss
over its share. Every rank of a ``dp x sp`` group reads another share, so
every gradient is averaged over that group: a ``tp`` shard's over the
ranks that hold the same shard, a whole parameter's over every rank (its
``tp`` replicas hold one gradient, up to the card's rounding). There is
no DistributedDataParallel here: it all-reduces every gradient over the
whole world, and so would sum the ``tp`` shards. The clip reads the norm
of the whole gradient: each shard counted once (its squared norm summed
over ``tp``), each whole parameter once. AdamW and the EMA then run on
what each rank holds. The loss reported is the mean over ``dp x sp``. With
every axis 1 the step is ``train/trainer.py``'s ``train_step``, bit for
bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tpuir_torch.parallel.collectives import all_reduce
from tpuir_torch.parallel.mesh import Mesh
from tpuir_torch.parallel.spatial import parallelize_spatial
from tpuir_torch.parallel.tensor import shard_params_tp
from tpuir_torch.train.trainer import TrainState


def parallelize(net: torch.nn.Module, mesh: Mesh, min_dim: Optional[int] = None
                ) -> torch.nn.Module:
    """``net``'s rows split over ``sp`` and, with ``min_dim``, its wide
    parameters over ``tp`` (``shard_params_tp``), in place; returns it."""
    parallelize_spatial(net, mesh)
    if min_dim is not None:
        shard_params_tp(net, mesh, min_dim)
    return net


def _mean(grads, group, n: int) -> None:
    """``grads`` summed over ``group`` and divided by ``n``, in place (one
    all-reduce of them all)."""
    if group is None or not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    flat /= n
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def average_gradients(params, mesh: Mesh) -> None:
    """Every gradient averaged over ``mesh``'s ``dp x sp`` ranks, in place: a
    ``tp`` shard's over the ranks that hold it (``grad_group``); a whole
    parameter's over every rank, the mean over its ``tp`` replicas of one
    gradient, which keeps the replicas bit-equal where the card's kernels
    round otherwise from run to run (atomic sums)."""
    if mesh.world == 1:
        return
    grads = [p for p in params if p.grad is not None]
    _mean([p.grad for p in grads if getattr(p, "tp_shard", None) is not None],
          mesh.grad_group, mesh.shape("dp") * mesh.shape("sp"))
    _mean([p.grad for p in grads if getattr(p, "tp_shard", None) is None],
          torch.distributed.group.WORLD, mesh.world)


def grad_norm(params, mesh: Mesh) -> torch.Tensor:
    """The global norm of the whole gradient (``optax.global_norm``), from
    this rank's: the ``tp`` shards' squared norms summed over ``tp``."""
    shards = [p.grad for p in params if getattr(p, "tp_shard", None) is not None]
    whole = [p.grad for p in params if getattr(p, "tp_shard", None) is None]
    sq = all_reduce(torch.nn.utils.get_total_norm(shards) ** 2, mesh.group("tp"))
    if whole:
        sq = sq + torch.nn.utils.get_total_norm(whole) ** 2
    return sq.sqrt()


def mesh_train_step(state: TrainState, mesh: Mesh, lq: torch.Tensor, gt: torch.Tensor,
                    loss_fn, grad_clip: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One step on this rank's share ``lq``, ``gt`` (NCHW): {loss (the mean
    over dp x sp), grad_norm}, detached tensors on the device."""
    loss = state.forward_loss(lq, gt, loss_fn)
    state.backward(loss)
    params = state.parameters()
    average_gradients(params, mesh)
    sharded = any(getattr(p, "tp_shard", None) is not None for p in params)
    gnorm = state.apply_gradients(grad_clip,
                                  (lambda ps: grad_norm(ps, mesh)) if sharded else None)
    loss = loss.detach()
    if mesh.grad_group is not None:
        loss = all_reduce(loss, mesh.grad_group) / (mesh.shape("dp") * mesh.shape("sp"))
    return {"loss": loss, "grad_norm": gnorm}
