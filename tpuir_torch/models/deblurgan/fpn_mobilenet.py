"""FPN-MobileNet generator (DeblurGANv2).

The PyTorch counterpart of ``tpuir/models/deblurgan/fpn_mobilenet.py``'s
plain layout (``phase_io=False``, ``fold_tail=False``; its phase-packed
convs are a TPU re-layout of the same math and have no counterpart here).
A MobileNetV2 backbone, of which the FPN uses features 0..15 with taps
after 1, 3, 6, 10 and 15, laterals, a top-down path, four heads, two
smoothing convs and the tail ``clip(tanh(final(up2(s))) + x, -1, 1)``.
Every norm is ``TrainNorm`` (train-mode statistics, per sample). Module
names are the original's (``fpn.features.{i}.conv.{j}``, ``fpn.lateral*``,
``fpn.td*.0``, ``head*.block*``, ``smooth.0``, ``smooth2.0``, ``final``),
so ``norms.load_checkpoint`` reads a released ``fpn_mobilenet.h5``.
Input and output are NCHW in [-1, 1].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

from tpuir_torch.utils.misc import seeded_state_dict

from .norms import (FPNHead, TrainNorm, conv_norm_relu, final_tail, put_conv, put_norm,
                    upsample_nearest)

# MobileNetV2's inverted-residual settings (t, c, n, s) expanded to
# (expand_ratio, out_ch, stride) for features 1..15.
MNV2_FEATURES = [
    (1, 16, 1),
    (6, 24, 2), (6, 24, 1),
    (6, 32, 2), (6, 32, 1), (6, 32, 1),
    (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
    (6, 96, 1), (6, 96, 1), (6, 96, 1),
    (6, 160, 2), (6, 160, 1),
]
TAPS = (1, 3, 6, 10, 15)


def _conv_bn(inp: int, oup: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(inp, oup, 3, stride, 1, bias=False),
                         TrainNorm(oup, affine=True), nn.ReLU6(inplace=True))


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.use_res_connect = stride == 1 and inp == oup
        dw = [nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden, bias=False),
              TrainNorm(hidden, affine=True), nn.ReLU6(inplace=True)]
        pw_linear = [nn.Conv2d(hidden, oup, 1, bias=False), TrainNorm(oup, affine=True)]
        pw = [] if expand_ratio == 1 else [
            nn.Conv2d(inp, hidden, 1, bias=False), TrainNorm(hidden, affine=True),
            nn.ReLU6(inplace=True)]
        self.conv = nn.Sequential(*pw, *dw, *pw_linear)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res_connect else y


class FPN(nn.Module):
    def __init__(self, num_filters: int = 128):
        super().__init__()
        layers, inp = [_conv_bn(3, 32, 2)], 32
        for t, c, s in MNV2_FEATURES:
            layers.append(InvertedResidual(inp, c, s, t))
            inp = c
        self.features = nn.Sequential(*layers)
        for k, cin in enumerate((16, 24, 32, 64, 160)):
            setattr(self, f"lateral{k}",
                    nn.Conv2d(cin, num_filters // 2 if k == 0 else num_filters, 1, bias=False))
        for k in (1, 2, 3):
            setattr(self, f"td{k}", conv_norm_relu(num_filters, num_filters))

    def forward(self, x: torch.Tensor):
        taps = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in TAPS:
                taps.append(x)
        enc0, enc1, enc2, enc3, enc4 = taps
        map4 = self.lateral4(enc4)
        map3 = self.td1(self.lateral3(enc3) + upsample_nearest(map4, 2))
        map2 = self.td2(self.lateral2(enc2) + upsample_nearest(map3, 2))
        map1 = self.td3(self.lateral1(enc1) + upsample_nearest(map2, 2))
        return self.lateral0(enc0), map1, map2, map3, map4


class FPNMobileNet(nn.Module):
    def __init__(self, output_ch: int = 3, num_filters: int = 64, num_filters_fpn: int = 128):
        super().__init__()
        nf = num_filters
        self.fpn = FPN(num_filters_fpn)
        for k in (1, 2, 3, 4):
            setattr(self, f"head{k}", FPNHead(num_filters_fpn, nf, nf))
        self.smooth = conv_norm_relu(4 * nf, nf)
        self.smooth2 = conv_norm_relu(nf, nf // 2)
        self.final = nn.Conv2d(nf // 2, output_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        map0, map1, map2, map3, map4 = self.fpn(x)
        map4 = upsample_nearest(self.head4(map4), 8)
        map3 = upsample_nearest(self.head3(map3), 4)
        map2 = upsample_nearest(self.head2(map2), 2)
        map1 = self.head1(map1)
        smoothed = self.smooth(torch.cat([map4, map3, map2, map1], dim=1))
        smoothed = self.smooth2(upsample_nearest(smoothed, 2) + map0)
        return final_tail(self.final, smoothed, x)


def put_fpn_tail(sd: Dict[str, torch.Tensor], p: Mapping[str, Any], top_down: bool = True) -> None:
    """The keys the FPN generators share: laterals, top-down convs (none
    without ``top_down``), heads, smoothing convs and the final conv (their
    norms' statistics included)."""
    for k in range(5):
        put_conv(sd, f"fpn.lateral{k}", p[f"lateral{k}"])
    tds = [(f"td{k}", f"fpn.td{k}") for k in (1, 2, 3)] if top_down else []
    for name, prefix in tds + [("smooth", "smooth"), ("smooth2", "smooth2")]:
        put_conv(sd, f"{prefix}.0", p[name]["conv"])
        put_norm(sd, f"{prefix}.1", len(p[name]["conv"]["bias"]))
    for k in (1, 2, 3, 4):
        for b in ("block0", "block1"):
            put_conv(sd, f"head{k}.{b}", p[f"head{k}"][b])
    put_conv(sd, "final", p["final"])


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's FPNMobileNet params as this module's state dict:
    the exact inverse of ``tpuir.models.deblurgan.fpn_mobilenet.
    convert_state_dict`` on the keys it reads, with each norm's running
    statistics (which nothing reads) at their initial values."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(base, j, conv, bn):  # the conv at {base}.{j}, its BatchNorm at j + 1
        put_conv(sd, f"{base}.{j}", conv)
        put_norm(sd, f"{base}.{j + 1}", len(bn["weight"]), bn)

    conv_bn("fpn.features.0", 0, p["features_0"]["conv"], p["features_0"]["bn"])
    for i, (t, _, _) in enumerate(MNV2_FEATURES, start=1):
        f = p[f"features_{i}"]
        names = ("dw", "pw_linear") if t == 1 else ("pw", "dw", "pw_linear")
        for j, name in enumerate(names):
            conv_bn(f"fpn.features.{i}.conv", 3 * j, f[name], f[f"{name}_bn"])
    put_fpn_tail(sd, p)
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``FPNMobileNet()``, running statistics
    random (nothing may read them)."""
    with torch.device("meta"):
        net = FPNMobileNet()
    return seeded_state_dict(net, seed, lambda n: 0.5 if n == "final.weight" else 1.0)
