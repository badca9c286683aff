"""FPN-Inception generator (DeblurGANv2).

The PyTorch counterpart of ``tpuir/models/deblurgan/fpn_inception.py:49-109``
with ``packed_tail=False`` and ``fold_tail=False``: the Inception-ResNet-v2
trunk's VALID (shrinking) maps re-aligned by reflect pads on the laterals,
exactly as the original pads them (symmetric 1 on lateral4, lateral3 and
lateral1, ``(1, 2, 1, 2)`` on lateral2 and ``(0, 1, 0, 1)`` on lateral0,
in ``F.pad``'s (left, right, top, bottom) order), the top-down path, four
heads, two smoothing convs and the tail. Module names are the original's
(``fpn.inception.*``, ``fpn.lateral*``, ``fpn.td*.0``, ``head*.block*``,
``smooth.0``, ``smooth2.0``, ``final``), so ``norms.load_checkpoint``
reads a released ``fpn_inception.h5``. Input and output are NCHW in
[-1, 1]; H and W must be multiples of 32 (the engine's always-pad gives
that).

In true float32 on the card (the engine's parity pin) the forward runs on
PyTorch's own convolutions, not cuDNN's: with TF32 off, cuDNN's choice for
a few of its convs at small batches is slow (the 256-to-128 head conv at
200x200 takes 316 ms at batch 1), so a forward of 768-pixel patches takes
300, 885 and 206 ms at batch 1, 2 and 8 on cuDNN against 43, 105 and 178
without it (``python -m tpuir_torch.utils.profiling --model
deblurgan-inception --layouts``, H100). Under TF32 cuDNN is faster and
runs it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import float32_pinned, seeded_state_dict, without_cudnn

from .fpn_mobilenet import put_fpn_tail
from .inception_resnet_v2 import InceptionTrunk, trunk_state_dict_from_jax
from .norms import FPNHead, conv_norm_relu, final_tail, upsample_nearest


def _reflect(x: torch.Tensor, pad) -> torch.Tensor:
    return F.pad(x, pad, mode="reflect")


class FPN(nn.Module):
    """The trunk, laterals and top-down path; with ``top_down=False`` the
    maps are the raw sums (FPN-Inception-Simple's, no ``td*`` blocks)."""

    def __init__(self, num_filters: int = 256, top_down: bool = True):
        super().__init__()
        self.inception = InceptionTrunk()
        for k, cin in enumerate((32, 64, 192, 1088, 2080)):
            setattr(self, f"lateral{k}",
                    nn.Conv2d(cin, num_filters // 2 if k == 0 else num_filters, 1, bias=False))
        for k in (1, 2, 3):
            setattr(self, f"td{k}", conv_norm_relu(num_filters, num_filters) if top_down
                    else nn.Identity())

    def forward(self, x: torch.Tensor):
        enc0, enc1, enc2, enc3, enc4 = self.inception(x)
        lateral4 = _reflect(self.lateral4(enc4), (1, 1, 1, 1))
        lateral3 = _reflect(self.lateral3(enc3), (1, 1, 1, 1))
        lateral2 = self.lateral2(enc2)
        lateral1 = _reflect(self.lateral1(enc1), (1, 1, 1, 1))
        lateral0 = self.lateral0(enc0)
        map4 = lateral4
        map3 = self.td1(lateral3 + upsample_nearest(map4, 2))
        map2 = self.td2(_reflect(lateral2, (1, 2, 1, 2)) + upsample_nearest(map3, 2))
        map1 = self.td3(lateral1 + upsample_nearest(map2, 2))
        return _reflect(lateral0, (0, 1, 0, 1)), map1, map2, map3, map4


class FPNInception(nn.Module):
    def __init__(self, output_ch: int = 3, num_filters: int = 128, num_filters_fpn: int = 256,
                 top_down: bool = True):
        super().__init__()
        nf = num_filters
        self.fpn = FPN(num_filters_fpn, top_down)
        for k in (1, 2, 3, 4):
            setattr(self, f"head{k}", FPNHead(num_filters_fpn, nf, nf))
        self.smooth = conv_norm_relu(4 * nf, nf)
        self.smooth2 = conv_norm_relu(nf, nf // 2)
        self.final = nn.Conv2d(nf // 2, output_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with without_cudnn() if float32_pinned(x) else contextlib.nullcontext():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        map0, map1, map2, map3, map4 = self.fpn(x)
        map4 = upsample_nearest(self.head4(map4), 8)
        map3 = upsample_nearest(self.head3(map3), 4)
        map2 = upsample_nearest(self.head2(map2), 2)
        map1 = self.head1(map1)
        smoothed = self.smooth(torch.cat([map4, map3, map2, map1], dim=1))
        smoothed = self.smooth2(upsample_nearest(smoothed, 2) + map0)
        return final_tail(self.final, smoothed, x)


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's FPNInception params as this module's state dict:
    the exact inverse of ``tpuir.models.deblurgan.fpn_inception.
    convert_state_dict``, each norm's running statistics (which nothing
    reads) at their initial values."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    trunk_state_dict_from_jax(sd, p["inception"], "fpn.inception")
    put_fpn_tail(sd, p)
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``FPNInception()``, running statistics
    random (nothing may read them)."""
    with torch.device("meta"):
        net = FPNInception()
    return seeded_state_dict(net, seed, lambda n: 0.5 if n == "final.weight" else 1.0)
