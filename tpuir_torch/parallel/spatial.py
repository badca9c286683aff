"""tpuir's ``sp`` axis: an image's height split over ranks, each holding
``H / sp`` rows, with the collectives XLA inserts for tpuir's
``P("dp", "sp", None, None)`` batch written out (``collectives.py``).

* A stride-1 convolution with padding ``k // 2`` (the 3x3 convs, dense and
  depthwise) takes ``k // 2`` rows of each neighbour (``halo_rows``), and
  zero rows at the image's top and bottom, as the unsharded zero pad does.
  Any other convolution with a kernel taller than one row raises: it does
  not split exactly.
* Pixel (un)shuffles, LayerNorms, the 1x1 convs and the MLPs act on a
  pixel or a 2x2 block of pixels, so they stay local (an odd local height
  makes ``F.pixel_unshuffle`` raise).
* Restormer's MDTA sums over every pixel: the squared L2 norms of q and k
  and the Gram ``q @ k^T`` are summed over ``sp`` (``reduce_sum``) before
  ``max(|.|, 1e-12)`` and the softmax; ``attn @ v`` is local.
* MaIR's ``SSMixer`` scans the whole image, its stripe route carrying the
  scan state from stripe to stripe: it runs on the height gathered over
  ``sp`` (``gather_own``, whose backward sums the ranks' gradients), and
  each rank keeps its own rows of the output. MaIRUNet's mixers are MaIR's.

``parallelize_spatial(model, mesh)`` swaps these modules' classes in place
(parameters and names stay); with no ``sp`` group the model is left as it is.
``MeshConv2d`` is also the column-parallel conv of ``tensor.py``: a 3x3
may be both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.models.mair import SSMixer
from tpuir_torch.models.restormer import MDTA, TransformerBlock
from tpuir_torch.parallel.collectives import (copy_to, gather_own, gather_same, halo_rows,
                                              reduce_sum)
from tpuir_torch.parallel.mesh import Mesh


class MeshConv2d(nn.Conv2d):
    """A conv with its rows split over ``sp_group`` (a halo of ``padding[0]``
    rows) and/or its output channels over ``tp`` ((group, index, size): the
    weight holds this rank's channels, the bias all of them)."""

    sp_group = None
    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the input's memory format for the conv and its output, as the
        # unsharded conv keeps it: the halo rows and the gathered channels
        # would turn a channels_last activation NCHW for every layer after,
        # on other cuDNN kernels than one process runs
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        pad_h, pad_w = self.padding
        bias, groups = self.bias, self.groups
        if self.tp is not None:
            group, index, size = self.tp
            x = copy_to(x, group)
            if groups > 1:  # grouped: this rank's groups' input channels
                n = x.shape[1] // size
                x, groups = x[:, index * n:(index + 1) * n], groups // size
            bias = None
        if self.sp_group is not None:
            x, pad_h = halo_rows(x, pad_h, 2, self.sp_group), 0
        y = F.conv2d(x.contiguous(memory_format=fmt), self.weight, bias, self.stride,
                     (pad_h, pad_w), self.dilation, groups)
        if self.tp is not None:
            y = gather_same(y, 1, self.tp[0])
            if self.bias is not None:
                y = y + self.bias.view(1, -1, 1, 1)
        return y.contiguous(memory_format=fmt)


def as_mesh_conv(conv: nn.Conv2d) -> MeshConv2d:
    if not isinstance(conv, MeshConv2d):
        if type(conv) is not nn.Conv2d or conv.padding_mode != "zeros":
            raise ValueError(f"{conv} is not a zero-padded nn.Conv2d")
        conv.__class__ = MeshConv2d
    return conv


class SpatialMDTA(MDTA):
    """MDTA on this rank's rows: the norms and the Gram summed over ``sp_group``."""

    sp_group = None

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w) for t in (q, k, v))
        g = self.sp_group
        q = q / reduce_sum((q * q).sum(-1, keepdim=True), g).sqrt().clamp_min(1e-12)
        k = k / reduce_sum((k * k).sum(-1, keepdim=True), g).sqrt().clamp_min(1e-12)
        attn = (reduce_sum(q @ k.transpose(-2, -1), g) * self.temperature).softmax(dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class SpatialSSMixer(SSMixer):
    """The mixer on the whole height, gathered over ``sp_group``; returns
    this rank's rows (h: (B, H / sp, W, C) NHWC)."""

    sp_group = None

    def forward(self, h: torch.Tensor, shift: bool = False) -> torch.Tensor:
        rows = h.shape[1]
        out = super().forward(gather_own(h, 1, self.sp_group), shift)
        i = torch.distributed.get_rank(self.sp_group)
        return out[:, i * rows:(i + 1) * rows]


def _swap(module: nn.Module, cls, group) -> None:
    module.__class__ = cls
    module.sp_group = group


def parallelize_spatial(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split ``model``'s rows over ``mesh``'s ``sp`` axis, in place (see the
    module docstring); returns it. Raises for a module it cannot split:
    Restormer's fused or serving blocks (K1 and the serving path read the
    whole image), a conv that is not stride 1 with padding ``k // 2``."""
    group = mesh.group("sp")
    if group is None:
        return model
    if any(getattr(p, "tp_shard", None) is not None for p in model.parameters()):
        raise ValueError("split the rows before shard_params_tp: it swaps the classes "
                         "this swaps")

    def visit(m: nn.Module) -> None:
        if isinstance(m, TransformerBlock) and (m.fused or m.serving):
            raise ValueError("a fused or serving Restormer block attends over the whole "
                             "image: split the plain model (fused=False), as tpuir trains it")
        if getattr(m, "serving", False) and not isinstance(m, (SSMixer, TransformerBlock)):
            raise ValueError(f"{type(m).__name__} in serving precision runs its own convs")
        if isinstance(m, SSMixer):
            _swap(m, SpatialSSMixer, group)
            return  # the mixer runs on the gathered height: its convs stay whole
        if isinstance(m, MDTA):
            _swap(m, SpatialMDTA, group)
        elif isinstance(m, nn.Conv2d) and m.kernel_size[0] > 1:
            kh, kw = m.kernel_size
            if (m.stride[0] != 1 or m.dilation[0] != 1 or kh % 2 == 0
                    or m.padding != (kh // 2, kw // 2)):
                raise ValueError(f"{m} does not split over rows: sp takes stride-1 convs "
                                 "with padding k // 2")
            as_mesh_conv(m).sp_group = group
        for child in m.children():
            visit(child)

    visit(model)
    return model
