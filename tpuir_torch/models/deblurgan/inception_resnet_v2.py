"""Inception-ResNet-v2 feature trunk, through mixed_7a.

The PyTorch counterpart of ``tpuir/models/deblurgan/inception_resnet_v2.py``
(``BasicConv2d`` through ``InceptionTrunk``): the stages the DeblurGANv2
FPN taps, with the Cadene/timm module names the released
``fpn_inception.h5`` uses under ``fpn.inception``:

  conv2d_1a .. maxpool_3a .. maxpool_5a .. mixed_5b .. repeat (10 x Block35)
  .. mixed_6a .. repeat_1 (20 x Block17) .. mixed_7a

``BasicConv2d`` is a conv without bias, a BatchNorm with eps 1e-3 (here
``TrainNorm``: train-mode statistics, per sample) and a ReLU. Convs are
VALID where the original pads 0; the 3x3 average pool of mixed_5b's
branch 3 leaves the padding out of its count.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .norms import TrainNorm, put_conv, put_norm


class BasicConv2d(nn.Module):
    def __init__(self, inp: int, out: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(inp, out, kernel, stride, padding, bias=False)
        self.bn = TrainNorm(out, affine=True, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _seq(*convs) -> nn.Sequential:
    return nn.Sequential(*(BasicConv2d(*c[:3], **(c[3] if len(c) > 3 else {})) for c in convs))


class Mixed5b(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(192, 96, 1)
        self.branch1 = _seq((192, 48, 1), (48, 64, 5, dict(padding=2)))
        self.branch2 = _seq((192, 64, 1), (64, 96, 3, dict(padding=1)),
                            (96, 96, 3, dict(padding=1)))
        self.branch3 = nn.Sequential(nn.AvgPool2d(3, stride=1, padding=1, count_include_pad=False),
                                     BasicConv2d(192, 64, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class Block35(nn.Module):
    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(320, 32, 1)
        self.branch1 = _seq((320, 32, 1), (32, 32, 3, dict(padding=1)))
        self.branch2 = _seq((320, 32, 1), (32, 48, 3, dict(padding=1)),
                            (48, 64, 3, dict(padding=1)))
        self.conv2d = nn.Conv2d(128, 320, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1))
        return F.relu(x + self.scale * up)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(320, 384, 3, stride=2)
        self.branch1 = _seq((320, 256, 1), (256, 256, 3, dict(padding=1)),
                            (256, 384, 3, dict(stride=2)))
        self.branch2 = nn.MaxPool2d(3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)


class Block17(nn.Module):
    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(1088, 192, 1)
        self.branch1 = _seq((1088, 128, 1), (128, 160, (1, 7), dict(padding=(0, 3))),
                            (160, 192, (7, 1), dict(padding=(3, 0))))
        self.conv2d = nn.Conv2d(384, 1088, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return F.relu(x + self.scale * up)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = _seq((1088, 256, 1), (256, 384, 3, dict(stride=2)))
        self.branch1 = _seq((1088, 256, 1), (256, 288, 3, dict(stride=2)))
        self.branch2 = _seq((1088, 256, 1), (256, 288, 3, dict(padding=1)),
                            (288, 320, 3, dict(stride=2)))
        self.branch3 = nn.MaxPool2d(3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class InceptionTrunk(nn.Module):
    """Returns (enc0, enc1, enc2, enc3, enc4) as the original FPN slices
    them: after conv2d_1a, maxpool_3a, maxpool_5a, mixed_6a and mixed_7a."""

    def __init__(self):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.maxpool_3a = nn.MaxPool2d(3, stride=2)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.maxpool_5a = nn.MaxPool2d(3, stride=2)
        self.mixed_5b = Mixed5b()
        self.repeat = nn.Sequential(*(Block35(0.17) for _ in range(10)))
        self.mixed_6a = Mixed6a()
        self.repeat_1 = nn.Sequential(*(Block17(0.10) for _ in range(20)))
        self.mixed_7a = Mixed7a()

    def forward(self, x: torch.Tensor):
        enc0 = self.conv2d_1a(x)
        enc1 = self.maxpool_3a(self.conv2d_2b(self.conv2d_2a(enc0)))
        enc2 = self.maxpool_5a(self.conv2d_4a(self.conv2d_3b(enc1)))
        enc3 = self.mixed_6a(self.repeat(self.mixed_5b(enc2)))
        enc4 = self.mixed_7a(self.repeat_1(enc3))
        return enc0, enc1, enc2, enc3, enc4


def trunk_state_dict_from_jax(sd: Dict[str, torch.Tensor], p: Mapping[str, Any],
                              prefix: str) -> None:
    """Add the trunk's keys under ``prefix`` to ``sd`` from tpuir's trunk
    params ``p``: the inverse of ``convert_trunk`` (``:188``)."""
    def basic(name, node):
        put_conv(sd, f"{name}.conv", node["conv"])
        put_norm(sd, f"{name}.bn", len(node["bn"]["weight"]), node["bn"])

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a"):
        basic(f"{prefix}.{name}", p[name])
    for name, node in p.items():
        if name.startswith("mixed_"):
            base = f"{prefix}.{name}"
        elif name.startswith("repeat_"):  # repeat_i: repeat.i; repeat_1_i: repeat_1.i
            stem, i = name.rsplit("_", 1)
            base = f"{prefix}.{stem}.{i}"
        else:
            continue
        for n, leaf in node.items():
            if n.startswith("branch"):  # branchX, or branchX_j: a Sequential's j-th conv
                stem, _, j = n.partition("_")
                basic(f"{base}.{stem}.{j}" if j else f"{base}.{stem}", leaf)
        if "conv2d" in node:
            put_conv(sd, f"{base}.conv2d", node["conv2d"])
