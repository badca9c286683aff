"""DeblurGANv2's discriminators (training side).

The PyTorch counterpart of ``tpuir/models/deblurgan/discriminators.py``:
``NLayerDiscriminator`` (PatchGAN: strided 4x4 stages, one stride-1 stage,
a 1-channel head), ``MultiScaleDiscriminator`` (one strided trunk, three
tails) and ``get_discriminator``. NCHW; every 4x4 conv pads 2 on each side,
so a strided stage gives floor(H/2) + 1. Module names are the original's
``model.N`` / ``scale_*.N`` / ``*_tail.model.N`` Sequential slots, so a
released state dict loads through ``norms.load_checkpoint``.

Norms: ``'instance'`` is ``TrainNorm`` without affine (per-sample moments,
the same in train and eval); ``'batch'`` is ``BatchNormTrain``, an affine
BatchNorm that always normalizes with the moments of the batch at hand
over (N, H, W) and never reads or writes running statistics (tpuir's
``_BatchNormTrain`` ``:29-45``): discriminators only exist in training.
The tails always take the affine batch norm, whatever the trunk's norm
(``:95-110``). A conv carries a bias only where the norm is instance.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import resolve_device

from .norms import TrainNorm, put_conv, put_norm


class BatchNormTrain(nn.Module):
    """Affine batch normalization with the current batch's statistics over
    (N, H, W), eps ``eps``. It holds a BatchNorm's running statistics under
    their names (a released checkpoint loads) and never reads them."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def _norm(kind: str, features: int) -> nn.Module:
    if kind == "instance":
        return TrainNorm(features)
    if kind == "batch":
        return BatchNormTrain(features)
    raise NotImplementedError(f"normalization layer [{kind}] is not found")


def _conv(cin: int, cout: int, stride: int, bias: bool) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride=stride, padding=2, bias=bias)


def _lrelu() -> nn.LeakyReLU:
    return nn.LeakyReLU(0.2)


def _stage(cin: int, cout: int, stride: int, norm: str):
    return [_conv(cin, cout, stride, norm == "instance"), _norm(norm, cout), _lrelu()]


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", use_sigmoid: bool = False):
        super().__init__()
        self.n_layers, self.norm = n_layers, norm
        seq = [_conv(input_nc, ndf, 2, True), _lrelu()]
        nf_mult = 1
        for n in range(1, n_layers):
            prev, nf_mult = nf_mult, min(2 ** n, 8)
            seq += _stage(ndf * prev, ndf * nf_mult, 2, norm)
        prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        seq += _stage(ndf * prev, ndf * nf_mult, 1, norm)
        seq.append(_conv(ndf * nf_mult, 1, 1, True))
        if use_sigmoid:
            seq.append(nn.Sigmoid())
        self.model = nn.Sequential(*seq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class DiscriminatorTail(nn.Module):
    """The original's ``DicsriminatorTail``: two stride-1 4x4 convs around
    an affine batch norm, to a 1-channel map."""

    def __init__(self, nf_mult_in: int, n_layers: int, ndf: int = 64):
        super().__init__()
        nf = ndf * min(2 ** n_layers, 8)
        self.model = nn.Sequential(_conv(ndf * nf_mult_in, nf, 1, False), BatchNormTrain(nf),
                                   _lrelu(), _conv(nf, 1, 1, True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class MultiScaleDiscriminator(nn.Module):
    """Returns [x_1, x_2, x_3], the three tails' maps."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.scale_one = nn.Sequential(_conv(input_nc, ndf, 2, True), _lrelu(),
                                       *_stage(ndf, ndf * 2, 2, norm),
                                       *_stage(ndf * 2, ndf * 4, 2, norm))
        self.first_tail = DiscriminatorTail(4, 3, ndf)
        self.scale_two = nn.Sequential(*_stage(ndf * 4, ndf * 8, 2, norm))
        self.second_tail = DiscriminatorTail(8, 4, ndf)
        self.scale_three = nn.Sequential(*_stage(ndf * 8, ndf * 8, 2, norm))
        self.third_tail = DiscriminatorTail(8, 5, ndf)

    def forward(self, x: torch.Tensor):
        x = self.scale_one(x)
        x_1 = self.first_tail(x)
        x = self.scale_two(x)
        x_2 = self.second_tail(x)
        x = self.scale_three(x)
        return [x_1, x_2, self.third_tail(x)]


def get_discriminator(model_config: Dict[str, Any], device="cuda") -> Dict[str, nn.Module]:
    """{'patch': D} / {'patch', 'full'} / {'multi_scale': D} / {} for
    ``no_gan``, on ``device`` (default card 0; raises without one)."""
    name = model_config["d_name"]
    norm = model_config.get("norm_layer", "instance")
    if name == "no_gan":
        return {}
    if name == "patch_gan":
        nets = {"patch": NLayerDiscriminator(n_layers=model_config["d_layers"], norm=norm)}
    elif name == "double_gan":
        nets = {"patch": NLayerDiscriminator(n_layers=model_config["d_layers"], norm=norm),
                "full": NLayerDiscriminator(n_layers=5, norm=norm)}
    elif name == "multi_scale":
        nets = {"multi_scale": MultiScaleDiscriminator(norm=norm)}
    else:
        raise ValueError(f"Discriminator Network [{name}] not recognized.")
    dev = resolve_device(device)
    return {k: net.to(dev) for k, net in nets.items()}


# The inverses of tpuir's ``convert_nlayer`` / ``convert_multiscale``
# (``:196-236``): every conv from its Flax kernel, a batch norm's affine
# from its params, every norm's running statistics (which nothing reads) at
# their initial values.


def _put_module(sd: Dict[str, torch.Tensor], prefix: str, module: nn.Module,
                node: Mapping[str, Any]) -> None:
    if isinstance(module, nn.Conv2d):
        put_conv(sd, prefix, node)
    elif isinstance(module, BatchNormTrain):
        put_norm(sd, prefix, module.weight.shape[0], node)
    elif isinstance(module, TrainNorm):
        put_norm(sd, prefix, module.running_mean.shape[0])


def _put_sequential(sd, prefix: str, flax_prefix: str, seq: nn.Sequential, p) -> None:
    for i, module in enumerate(seq):
        _put_module(sd, f"{prefix}.{i}", module, p.get(f"{flax_prefix}_{i}", {}))


def state_dict_from_jax(params: Mapping[str, Any], net: nn.Module) -> Dict[str, torch.Tensor]:
    """tpuir's discriminator params as the state dict of ``net`` (an
    ``NLayerDiscriminator`` or ``MultiScaleDiscriminator`` of the same
    configuration; the meta device will do)."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(net, NLayerDiscriminator):
        _put_sequential(sd, "model", "model", net.model, p)
        return sd
    for scale in ("scale_one", "scale_two", "scale_three"):
        _put_sequential(sd, scale, scale, getattr(net, scale), p)
    for tail in ("first_tail", "second_tail", "third_tail"):
        _put_sequential(sd, f"{tail}.model", "model", getattr(net, tail).model, p[tail])
    return sd
