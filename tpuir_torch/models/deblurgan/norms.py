"""Train-mode normalization and shared pieces of the DeblurGANv2 generators.

The original serves its generators in train mode, so every InstanceNorm2d
and every backbone BatchNorm2d normalizes with the statistics of the tensor
at hand, never the checkpoint's running ones; fed one patch at a time, the
BatchNorms' batch statistics are a patch's own. ``TrainNorm`` is that, as
``tpuir/models/deblurgan/norms.py:21`` implements it (its unpacked branch):
per-sample, per-channel spatial moments, so a batch of patches gives each
patch what it gives alone. ``nn.BatchNorm2d`` would not: in train mode
with a batch above 1 it pools the batch, and in eval mode it reads the
running statistics. ``TrainNorm`` still holds the checkpoint's
``running_mean``, ``running_var`` and ``num_batches_tracked`` under their
names, so a released state dict loads, and never reads them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import resolve_device

_STATS = ("running_mean", "running_var", "num_batches_tracked")


class TrainNorm(nn.Module):
    """Per-sample spatial normalization of NCHW, eps ``eps``, with an
    optional affine (the BatchNorms' ``weight`` and ``bias``)."""

    def __init__(self, num_features: int, affine: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays float64
        var, mu = torch.var_mean(x32, dim=(2, 3), correction=0, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest upsampling of NCHW."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def final_tail(final: nn.Conv2d, smoothed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The generators' tail, ``clip(tanh(final(up2(smoothed))) + x, -1, 1)``:
    the plain branch of ``tpuir/models/deblurgan/fold.py:239 FinalTail``."""
    return torch.clamp(torch.tanh(final(upsample_nearest(smoothed, 2))) + x, -1.0, 1.0)


class FPNHead(nn.Module):
    def __init__(self, num_in: int, num_mid: int, num_out: int):
        super().__init__()
        self.block0 = nn.Conv2d(num_in, num_mid, 3, padding=1, bias=False)
        self.block1 = nn.Conv2d(num_mid, num_out, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.block1(F.relu(self.block0(x))))


def conv_norm_relu(cin: int, cout: int) -> nn.Sequential:
    """The FPN's ``td*``, ``smooth`` and ``smooth2``: a biased 3x3 conv, the
    train-mode InstanceNorm (no affine), ReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), TrainNorm(cout),
                         nn.ReLU(inplace=True))


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop DataParallel's ``module.`` from the keys."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_checkpoint(net: nn.Module, sd: Mapping[str, Any]) -> nn.Module:
    """Load a released generator state dict (the ``.h5``'s ``model``) into
    ``net``: the counterpart of tpuir's ``convert_state_dict`` for these
    generators. ``module.`` prefixes are stripped; keys ``net`` does not
    hold (the original's ``fpn.enc*`` aliases of the backbone, its unused
    last stages) are ignored, as tpuir's converters ignore them; a missing
    parameter or a misshapen tensor raises. A missing running statistic
    keeps its initial value, since none is read."""
    sd = strip_module_prefix(sd)
    own = net.state_dict()
    res = net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items() if k in own},
                              strict=False)
    missing = [k for k in res.missing_keys if k.rsplit(".", 1)[-1] not in _STATS]
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    return net


def build_on(device, net_fn, state_dict) -> nn.Module:
    """The extra generators' builders: ``net_fn()`` with ``state_dict``
    loaded (``load_checkpoint``), on ``device`` (card 0 for ``cuda``;
    raises without a card before building)."""
    dev = resolve_device(device)
    return load_checkpoint(net_fn(), state_dict).to(dev)


# Helpers of the ``state_dict_from_jax`` inverses of tpuir's converters.


def _oihw(node: Mapping[str, Any]) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def put_conv(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _oihw(node)
    if "bias" in node:
        sd[f"{prefix}.bias"] = _vec(node["bias"])


def put_norm(sd: Dict[str, torch.Tensor], prefix: str, size: int, affine=None) -> None:
    """A TrainNorm's keys: its affine from ``affine`` (a BatchNorm's) and its
    running statistics, which nothing reads, at their initial values."""
    if affine is not None:
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _vec(affine["weight"]), _vec(affine["bias"])
    sd[f"{prefix}.running_mean"] = torch.zeros(size)
    sd[f"{prefix}.running_var"] = torch.ones(size)
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
