"""UNet-SEResNeXt generator (DeblurGANv2, ``g_name: unet_seresnext``).

The PyTorch counterpart of ``tpuir/models/deblurgan/unet_seresnext.py``:
an SE-ResNeXt-50 32x4d encoder (the original's vendored ``senet.py``, in
which every BatchNorm is an InstanceNorm without affine: here
``TrainNorm``; grouped 3x3 convs, 32 groups; a 3x3/2 ceil-mode max pool,
whose last partial window tpuir pads with -inf, ``:26-37``), a center of
two conv-ReLUs, five decoder blocks (conv-ReLU, ``ConvTranspose2d(k4, s2,
p1)`` with weights in torch's (in, out, kh, kw), norm, ReLU), the four
deeper decoder maps brought up bilinearly (``align_corners=False``) and
concatenated with the first, a conv-ReLU and a 1x1 head (no tanh, no
residual). Every conv carries a bias, as tpuir's module does. Module names
are the original's (``encoder.layer*``, ``center.block.*``,
``dec*.block.*``, ``dec0.conv``, ``final``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import seeded_state_dict

from .norms import TrainNorm, _vec, build_on, put_conv, put_norm

LAYERS = (3, 4, 6, 3)


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class SEResNeXtBottleneck(nn.Module):
    """1x1, grouped 3x3 (the stride), 1x1, SE, residual."""

    def __init__(self, inplanes: int, planes: int, groups: int = 32, reduction: int = 16,
                 stride: int = 1, base_width: int = 4, downsample: bool = False):
        super().__init__()
        width = (planes * base_width // 64) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1)
        self.bn1 = TrainNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=groups)
        self.bn2 = TrainNorm(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1)
        self.bn3 = TrainNorm(planes * 4)
        self.se_module = SEModule(planes * 4, reduction)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride=stride),
                                         TrainNorm(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.se_module(out) + residual)


class SEResNeXt50Trunk(nn.Module):
    """se_resnext50_32x4d's features: (layer0 .. layer4)."""

    def __init__(self, layers: Sequence[int] = LAYERS):
        super().__init__()
        self.layer0 = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 64, 7, stride=2, padding=3)), ("bn1", TrainNorm(64)),
            ("relu1", nn.ReLU()), ("pool", nn.MaxPool2d(3, stride=2, ceil_mode=True))]))
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                          (1, 2, 2, 2)), start=1):
            mods = []
            for b in range(blocks):
                ds = b == 0 and (stride != 1 or inplanes != planes * 4)
                mods.append(SEResNeXtBottleneck(inplanes, planes, stride=stride if b == 0 else 1,
                                                downsample=ds))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor):
        l0 = self.layer0(x)
        l1 = self.layer1(l0)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l0, l1, l2, l3, self.layer4(l3)


class ConvRelu(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


class DecoderBlockV(nn.Module):
    """The ``is_deconv=True`` layout: conv-ReLU, the k4/s2 transposed conv,
    the instance norm, ReLU."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(ConvRelu(cin, mid),
                                   nn.ConvTranspose2d(mid, cout, 4, stride=2, padding=1),
                                   TrainNorm(cout), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DecoderCenter(nn.Module):
    """Built with ``is_deconv=False`` in the original: two conv-ReLUs."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(ConvRelu(cin, mid), ConvRelu(mid, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


def _bilinear_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


class UNetSEResNext(nn.Module):
    def __init__(self, num_classes: int = 3, num_filters: int = 32, is_deconv: bool = True):
        super().__init__()
        if not is_deconv:
            raise NotImplementedError("only the is_deconv=True layout is built")
        nf = num_filters
        self.encoder = SEResNeXt50Trunk()
        self.center = DecoderCenter(2048, nf * 16, nf * 8)
        self.dec5 = DecoderBlockV(2048 + nf * 8, nf * 16, nf * 2)
        self.dec4 = DecoderBlockV(1024 + nf * 2, nf * 8, nf * 2)
        self.dec3 = DecoderBlockV(512 + nf * 2, nf * 4, nf * 2)
        self.dec2 = DecoderBlockV(256 + nf * 2, nf * 2, nf * 2)
        self.dec1 = DecoderBlockV(nf * 2, nf, nf * 2)
        self.dec0 = ConvRelu(nf * 2 * 5, nf * 2)
        self.final = nn.Conv2d(nf * 2, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l0, l1, l2, l3, l4 = self.encoder(x)
        center = self.center(l4)
        dec5 = self.dec5(torch.cat([center, l4], 1))
        dec4 = self.dec4(torch.cat([dec5, l3], 1))
        dec3 = self.dec3(torch.cat([dec4, l2], 1))
        dec2 = self.dec2(torch.cat([dec3, l1], 1))
        dec1 = self.dec1(dec2)
        f = torch.cat([dec1, _bilinear_up(dec2, 2), _bilinear_up(dec3, 4),
                       _bilinear_up(dec4, 8), _bilinear_up(dec5, 16)], 1)
        return self.final(self.dec0(f))


def state_dict_from_jax(params: Mapping[str, Any],
                        layers: Sequence[int] = LAYERS) -> Dict[str, torch.Tensor]:
    """tpuir's ``UNetSEResNext`` params as this module's state dict: the
    inverse of its ``convert_state_dict`` (the grouped conv's kernel is
    (3, 3, I/g, O) in Flax, (O, I/g, 3, 3) here)."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def conv_norm(prefix, norm_prefix, node):
        put_conv(sd, prefix, node)
        put_norm(sd, norm_prefix, node["kernel"].shape[-1])

    enc = p["encoder"]
    conv_norm("encoder.layer0.conv1", "encoder.layer0.bn1", enc["layer0_conv1"])
    for li, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            node, pre = enc[f"layer{li}_{b}"], f"encoder.layer{li}.{b}"
            for i in (1, 2, 3):
                conv_norm(f"{pre}.conv{i}", f"{pre}.bn{i}", node[f"conv{i}"])
            for fc in ("fc1", "fc2"):
                put_conv(sd, f"{pre}.se_module.{fc}", node["se_module"][fc])
            if "downsample_0" in node:
                conv_norm(f"{pre}.downsample.0", f"{pre}.downsample.1", node["downsample_0"])
    put_conv(sd, "center.block.0.conv", p["center_cr0"]["conv"])
    put_conv(sd, "center.block.1.conv", p["center_cr1"]["conv"])
    for name in ("dec5", "dec4", "dec3", "dec2", "dec1"):
        node = p[name]
        put_conv(sd, f"{name}.block.0.conv", node["cr"]["conv"])
        sd[f"{name}.block.1.weight"] = _vec(node["deconv_kernel"])
        sd[f"{name}.block.1.bias"] = _vec(node["deconv_bias"])
        put_norm(sd, f"{name}.block.2", node["deconv_kernel"].shape[1])
    put_conv(sd, "dec0.conv", p["dec0"]["conv"])
    put_conv(sd, "final", p["final"])
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``UNetSEResNext()``."""
    with torch.device("meta"):
        net = UNetSEResNext()
    return seeded_state_dict(net, seed)


def build(state_dict=None, device="cuda", seed: int = 0) -> UNetSEResNext:
    """``UNetSEResNext()`` with ``state_dict`` (else seeded weights) on
    ``device`` (default card 0; raises without one)."""
    return build_on(device, UNetSEResNext,
                    init_state_dict(seed) if state_dict is None else state_dict)
