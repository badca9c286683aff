"""tpuir's ``tp`` axis: ``shard_params_tp`` and the layers that run on the shards.

tpuir's rule (``tpuir/parallel/mesh.py:shard_params_tp``) reads each
parameter's JAX leaf: a leaf of two axes or more whose last axis is at
least ``max(min_dim, tp)`` and divisible by ``tp`` is sharded on that axis
over ``tp``; every other leaf, biases and 1-D leaves among them, is
replicated. ``jax_layout`` maps that last axis to the torch layout, as the
port's ``state_dict_from_jax`` functions lay the leaves out: the output
channels (dim 0) of a conv's OIHW weight, of a depthwise conv's
(C, 1, kh, kw) and of a ``Linear``'s (out, in); for MaIR's mixer leaves,
their own axis (``x_proj_weight``'s d_inner, ``Ds`` as (K, d_inner), ...).

A sharded parameter holds this rank's slice (its ``tp_shard`` attribute:
the full shape, the view and axis it was cut on). Where it runs:

* a conv or ``Linear`` called as a module outside the mixer is
  column-parallel: it computes its share of output channels from the
  replicated input (``copy_to``: its backward sums over ``tp``; a grouped
  conv takes its groups' input channels first), then all-gathers them
  (``gather_same``) and adds the whole bias;
* every other sharded leaf (the mixer's, which the hand kernels K6, K2 and
  K7 read, as XLA gathers its leaves around a ``pallas_call``) is
  all-gathered before use, through a parametrization.

``full_state_dict`` gathers the shards back into the torch-layout dict the
zoo serves and ``scripts/test.py`` reads.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from tpuir_torch.models.mair import K, ShuffleAttn, SSMixer
from tpuir_torch.models.restormer import MDTA, TransformerBlock
from tpuir_torch.parallel.collectives import all_gather, copy_to, gather_same
from tpuir_torch.parallel.mesh import Mesh
from tpuir_torch.parallel.spatial import as_mesh_conv


class Shard(NamedTuple):
    """A ``tp`` shard: the full tensor's shape, the view it was cut in, the
    axis of that view it was cut on."""

    full: Tuple[int, ...]
    view: Tuple[int, ...]
    axis: int


class MeshLinear(nn.Linear):
    """A column-parallel ``Linear``: ``tp`` is (group, index, size), the
    weight this rank's output rows, the bias all of them."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.tp[0]
        y = gather_same(F.linear(copy_to(x, group), self.weight), -1, group)
        return y if self.bias is None else y + self.bias


class GatherShards(nn.Module):
    """The parametrization of a leaf with no column-parallel layer: the
    whole tensor, all-gathered from the ``tp`` shards."""

    def __init__(self, shard: Shard, group):
        super().__init__()
        self.shard, self.group = shard, group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_same(x, self.shard.axis, self.group).reshape(self.shard.full)


_MIXER_AXES = {  # leaf -> (its JAX shape from the torch tensor's, the last axis there)
    "x_proj_weight": (lambda s: s, 2), "dt_projs_weight": (lambda s: s, 2),
    "dt_projs_bias": (lambda s: s, 1), "A_logs": (lambda s: (K, s[0] // K, s[1]), 2),
    "Ds": (lambda s: (K, s[0] // K), 1),
}


def jax_layout(owner: nn.Module, leaf: str, param: torch.Tensor, gate: bool = False
               ) -> Optional[Tuple[Tuple[int, ...], int]]:
    """(the view of ``param`` laid out as its JAX leaf's axes, the axis there
    that is the leaf's last), or None for a leaf of one axis; ``gate``: the
    owner is a ``ShuffleAttn``'s conv."""
    shape = tuple(param.shape)
    if gate:  # gate_weight (d, K, K), gate_bias (d, K)
        view = (shape[0] // K, K, K) if leaf.endswith("weight") else (shape[0] // K, K)
        return view, len(view) - 1
    if isinstance(owner, (nn.Conv2d, nn.Linear)):
        return (shape, 0) if leaf == "weight" else None
    if isinstance(owner, SSMixer) and leaf in _MIXER_AXES:
        view, axis = _MIXER_AXES[leaf]
        return tuple(view(shape)), axis
    if isinstance(owner, MDTA) and leaf == "temperature":  # (heads, 1, 1) as in JAX
        return shape, 2
    if param.dim() == 1:
        return None
    raise ValueError(f"no JAX layout known for {type(owner).__name__}.{leaf} {shape}")


def _sharded(layout, tp: int, min_dim: int) -> bool:
    if layout is None:
        return False
    view, axis = layout
    return len(view) >= 2 and view[axis] >= max(min_dim, tp) and view[axis] % tp == 0


def tp_leaves(model: nn.Module, tp: int, min_dim: int = 128) -> Dict[str, Tuple]:
    """{parameter name: (owner, leaf, view, axis, column-parallel)} of the
    parameters tpuir's rule shards over ``tp`` ranks."""
    out = {}

    def visit(m: nn.Module, prefix: str, in_mixer: bool, gate: bool) -> None:
        for leaf, p in m.named_parameters(recurse=False):
            layout = jax_layout(m, leaf, p, gate)
            if _sharded(layout, tp, min_dim):
                column = (not in_mixer and leaf == "weight"
                          and isinstance(m, (nn.Conv2d, nn.Linear)))
                out[prefix + leaf] = (m, leaf, layout[0], layout[1], column)
        for name, child in m.named_children():
            visit(child, f"{prefix}{name}.", in_mixer or isinstance(m, SSMixer),
                  gate or isinstance(m, ShuffleAttn))

    visit(model, "", False, False)
    return out


def shard_params_tp(model: nn.Module, mesh: Mesh, min_dim: int = 128) -> nn.Module:
    """tpuir's tensor-parallel placement on ``model``, in place: each
    parameter tpuir shards over ``tp`` keeps this rank's slice and runs as
    the module docstring says. With no ``tp`` group the model is left as it
    is. Returns the model."""
    group = mesh.group("tp")
    if group is None:
        return model
    tp, index = mesh.shape("tp"), mesh.coord("tp")
    for m in model.modules():
        if isinstance(m, TransformerBlock) and (m.fused or m.serving):
            raise ValueError("a fused or serving Restormer block reads its weights itself: "
                             "shard the plain model (fused=False), as tpuir trains it")
    for name, (m, leaf, view, axis, column) in tp_leaves(model, tp, min_dim).items():
        full = getattr(m, leaf)
        n = view[axis] // tp
        part = full.detach().reshape(view).narrow(axis, index * n, n).contiguous()
        shard = nn.Parameter(part, requires_grad=full.requires_grad)
        shard.tp_shard = Shard(tuple(full.shape), view, axis)
        if column and isinstance(m, nn.Conv2d):
            if m.groups > 1 and m.groups % tp:
                raise ValueError(f"{name}: {m.groups} groups do not split over {tp} ranks")
            as_mesh_conv(m).tp = (group, index, tp)
        elif column:
            m.__class__ = MeshLinear
            m.tp = (group, index, tp)
        setattr(m, leaf, shard)
        if not column:
            parametrize.register_parametrization(m, leaf, GatherShards(shard.tp_shard, group),
                                                 unsafe=True)
    return model


def tensor_name(name: str) -> str:
    """A parameter's name as the state dict of the unsharded model has it
    (a parametrized leaf's ``parametrizations.<leaf>.original`` -> ``<leaf>``)."""
    return re.sub(r"parametrizations\.(\w+)\.original$", r"\1", name)


def full_tensors(model: nn.Module, mesh: Mesh, tensors: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``tensors`` ({parameter name: a tensor of its shape}, e.g. the
    gradients or an EMA copy) with each ``tp`` shard all-gathered whole,
    under the unsharded model's names (no autograd)."""
    params = dict(model.named_parameters())
    group = mesh.group("tp")
    out = {}
    for name, t in tensors.items():
        shard = getattr(params.get(name), "tp_shard", None)
        if shard is not None:
            t = torch.cat(all_gather(t.detach(), group), shard.axis).reshape(shard.full)
        out[tensor_name(name)] = t.detach()
    return out


@torch.no_grad()
def full_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The unsharded model's state dict (torch layout, every shard gathered)."""
    sd = model.state_dict(keep_vars=True)
    return full_tensors(model, mesh, {name: t for name, t in sd.items()})
