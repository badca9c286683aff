"""VGG19's conv3_3 feature trunk for DeblurGANv2's PerceptualLoss.

The PyTorch counterpart of ``tpuir/train/vgg_features.py``: torchvision's
``vgg19().features[:15]`` (layers through index 14, conv3_3, with no ReLU
after it), built here, since the card's machine has no torchvision. The
Sequential's slots are torchvision's, so ``features.N`` keys of a
torchvision VGG19 checkpoint (or the bare ``N`` keys of the original's
sliced ``nn.Sequential``) load as they are (``load_vgg19_features``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from tpuir_torch.models.deblurgan.norms import put_conv
from tpuir_torch.utils.misc import seeded_state_dict

# torchvision vgg19 features[0..14]: (conv out-channels, sequential index)
_CONVS = [(64, 0), (64, 2), (128, 5), (128, 7), (256, 10), (256, 12), (256, 14)]
_POOL_AFTER = {2, 7}  # max pools at sequential indices 4 and 9

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class VGG19Conv33(nn.Module):
    """NCHW input in ImageNet-normalized space; conv3_3's output, pre-ReLU."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for cout, idx in _CONVS:
            layers.append(nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
            if idx != 14:
                layers.append(nn.ReLU())
            if idx in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, stride=2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def load_vgg19_features(net: VGG19Conv33, sd: Mapping[str, Any]) -> VGG19Conv33:
    """Load a torchvision VGG19 state dict (``features.N.*``; the classifier
    and the layers past conv3_3 ignored) or the original's sliced
    Sequential (``N.*``) into ``net``."""
    own = {}
    for _, idx in _CONVS:
        k = f"features.{idx}" if f"features.{idx}.weight" in sd else str(idx)
        for leaf in ("weight", "bias"):
            own[f"features.{idx}.{leaf}"] = torch.as_tensor(np.asarray(sd[f"{k}.{leaf}"]))
    net.load_state_dict(own)
    return net


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpuir's ``VGG19Conv33`` params as this module's state dict: the
    inverse of ``tpuir.train.vgg_features.convert_vgg19_features``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for _, idx in _CONVS:
        put_conv(sd, f"features.{idx}", p[f"features_{idx}"])
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``VGG19Conv33()`` in torchvision's keys."""
    with torch.device("meta"):
        net = VGG19Conv33()
    return seeded_state_dict(net, seed)
