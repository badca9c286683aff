"""FPN-DenseNet generator (DeblurGANv2, ``g_name: fpn_dense``).

The PyTorch counterpart of ``tpuir/models/deblurgan/fpn_densenet.py``: a
DenseNet-121 feature trunk in torchvision's layout (``conv0``, ``norm0``,
a 3x3/2 max pool, dense blocks of 6, 12, 24 and 16 layers with growth 32
and bn_size 4, each layer's output concatenated after its input,
transitions halving the channels and pooling, ``norm5``), laterals, the
top-down path, four heads, two conv-BN-ReLU smoothing stages and a plain
tanh (no residual). Every BatchNorm is ``BatchNormTrain``: the statistics
of the batch at hand, never the running ones (train mode, as tpuir). Module
names are the original's (``fpn.features.*``, ``fpn.lateral*``,
``head*.block*``, ``smooth.{0,1}``, ``smooth2.{0,1}``, ``final``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import seeded_state_dict

from .discriminators import BatchNormTrain
from .norms import FPNHead, build_on, put_conv, put_norm, upsample_nearest

BLOCKS = (6, 12, 24, 16)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int = 32, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNormTrain(cin)
        self.conv1 = nn.Conv2d(cin, bn_size * growth, 1, bias=False)
        self.norm2 = BatchNormTrain(bn_size * growth)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], 1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = BatchNormTrain(cin)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, stride=2)


class DenseNet121Trunk(nn.Module):
    """(enc0, enc1, enc2, enc3, enc4) as the FPN taps them: enc0 before
    the pool, encN the dense block N's output, enc4 after norm5 (no ReLU)."""

    def __init__(self, blocks: Sequence[int] = BLOCKS, growth: int = 32):
        super().__init__()
        self.blocks = tuple(blocks)
        self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.norm0 = BatchNormTrain(64)
        feats = 64
        for bi, n_layers in enumerate(self.blocks, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                block.add_module(f"denselayer{li}", DenseLayer(feats + (li - 1) * growth, growth))
            setattr(self, f"denseblock{bi}", block)
            feats += n_layers * growth
            if bi != len(self.blocks):
                setattr(self, f"transition{bi}", Transition(feats, feats // 2))
                feats //= 2
        self.norm5 = BatchNormTrain(feats)

    def forward(self, x: torch.Tensor):
        enc0 = F.relu(self.norm0(self.conv0(x)))
        h = F.max_pool2d(enc0, 3, stride=2, padding=1)
        encs = []
        for bi in range(1, len(self.blocks) + 1):
            for layer in getattr(self, f"denseblock{bi}").children():
                h = layer(h)
            encs.append(h)
            if bi != len(self.blocks):
                h = getattr(self, f"transition{bi}")(h)
        return (enc0, encs[0], encs[1], encs[2], self.norm5(encs[3]))


class FPN(nn.Module):
    def __init__(self, num_filters: int = 256):
        super().__init__()
        self.features = DenseNet121Trunk()
        for k, cin in enumerate((64, 256, 512, 1024, 1024)):
            setattr(self, f"lateral{k}",
                    nn.Conv2d(cin, num_filters // 2 if k == 0 else num_filters, 1, bias=False))

    def forward(self, x: torch.Tensor):
        enc0, enc1, enc2, enc3, enc4 = self.features(x)
        map4 = self.lateral4(enc4)
        map3 = self.lateral3(enc3) + upsample_nearest(map4, 2)
        map2 = self.lateral2(enc2) + upsample_nearest(map3, 2)
        map1 = self.lateral1(enc1) + upsample_nearest(map2, 2)
        return self.lateral0(enc0), map1, map2, map3, map4


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), BatchNormTrain(cout), nn.ReLU())


class FPNDense(nn.Module):
    def __init__(self, output_ch: int = 3, num_filters: int = 128, num_filters_fpn: int = 256):
        super().__init__()
        nf = num_filters
        self.fpn = FPN(num_filters_fpn)
        for k in (1, 2, 3, 4):
            setattr(self, f"head{k}", FPNHead(num_filters_fpn, nf, nf))
        self.smooth = _conv_bn_relu(4 * nf, nf)
        self.smooth2 = _conv_bn_relu(nf, nf // 2)
        self.final = nn.Conv2d(nf // 2, output_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        map0, map1, map2, map3, map4 = self.fpn(x)
        map4 = upsample_nearest(self.head4(map4), 8)
        map3 = upsample_nearest(self.head3(map3), 4)
        map2 = upsample_nearest(self.head2(map2), 2)
        map1 = self.head1(map1)
        smoothed = self.smooth(torch.cat([map4, map3, map2, map1], dim=1))
        smoothed = self.smooth2(upsample_nearest(smoothed, 2) + map0)
        return torch.tanh(self.final(upsample_nearest(smoothed, 2)))


def state_dict_from_jax(params: Mapping[str, Any],
                        blocks: Sequence[int] = BLOCKS) -> Dict[str, torch.Tensor]:
    """tpuir's ``FPNDense`` params as this module's state dict: the inverse
    of its ``convert_state_dict``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix, node):
        put_norm(sd, prefix, len(node["weight"]), node)

    tr, base = p["features"], "fpn.features"
    put_conv(sd, f"{base}.conv0", tr["conv0"])
    bn(f"{base}.norm0", tr["norm0"])
    for bi, n_layers in enumerate(blocks, start=1):
        for li in range(1, n_layers + 1):
            node, pre = tr[f"denseblock{bi}_{li}"], f"{base}.denseblock{bi}.denselayer{li}"
            for name in ("norm1", "norm2"):
                bn(f"{pre}.{name}", node[name])
            for name in ("conv1", "conv2"):
                put_conv(sd, f"{pre}.{name}", node[name])
        if bi != len(blocks):
            node = tr[f"transition{bi}"]
            bn(f"{base}.transition{bi}.norm", node["norm"])
            put_conv(sd, f"{base}.transition{bi}.conv", node["conv"])
    bn(f"{base}.norm5", tr["norm5"])
    for k in range(5):
        put_conv(sd, f"fpn.lateral{k}", p[f"lateral{k}"])
    for k in (1, 2, 3, 4):
        for b in ("block0", "block1"):
            put_conv(sd, f"head{k}.{b}", p[f"head{k}"][b])
    for name in ("smooth", "smooth2"):
        put_conv(sd, f"{name}.0", p[name]["conv"])
        bn(f"{name}.1", p[name]["norm"])
    put_conv(sd, "final", p["final"])
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``FPNDense()``."""
    with torch.device("meta"):
        net = FPNDense()
    return seeded_state_dict(net, seed, lambda n: 0.5 if n == "final.weight" else 1.0)


def build(state_dict=None, device="cuda", seed: int = 0) -> FPNDense:
    """``FPNDense()`` with ``state_dict`` (else seeded weights) on
    ``device`` (default card 0; raises without one)."""
    return build_on(device, FPNDense, init_state_dict(seed) if state_dict is None else state_dict)
