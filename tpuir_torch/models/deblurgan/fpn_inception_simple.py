"""FPN-Inception-Simple generator (DeblurGANv2, ``g_name:
fpn_inception_simple``).

The PyTorch counterpart of ``tpuir/models/deblurgan/fpn_inception_simple.py``:
FPN-Inception whose top-down path adds the laterals raw, with no
conv-norm-ReLU ``td*`` blocks (``:29-66``); trunk, reflect re-alignment
pads, heads, smoothing convs and tail are FPN-Inception's. Module names
are the original's, so ``norms.load_checkpoint`` reads its state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from tpuir_torch.utils.misc import seeded_state_dict

from .fpn_inception import FPNInception
from .fpn_mobilenet import put_fpn_tail
from .inception_resnet_v2 import trunk_state_dict_from_jax
from .norms import build_on


class FPNInceptionSimple(FPNInception):
    def __init__(self, output_ch: int = 3, num_filters: int = 128, num_filters_fpn: int = 256):
        super().__init__(output_ch, num_filters, num_filters_fpn, top_down=False)


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """tpuir's ``FPNInceptionSimple`` params as this module's state dict:
    the inverse of its ``convert_state_dict``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    trunk_state_dict_from_jax(sd, p["inception"], "fpn.inception")
    put_fpn_tail(sd, p, top_down=False)
    return sd


def init_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``FPNInceptionSimple()``."""
    with torch.device("meta"):
        net = FPNInceptionSimple()
    return seeded_state_dict(net, seed, lambda n: 0.5 if n == "final.weight" else 1.0)


def build(state_dict=None, device="cuda", seed: int = 0) -> FPNInceptionSimple:
    """``FPNInceptionSimple()`` with ``state_dict`` (else seeded weights) on
    ``device`` (default card 0; raises without one)."""
    return build_on(device, FPNInceptionSimple,
                    init_state_dict(seed) if state_dict is None else state_dict)
