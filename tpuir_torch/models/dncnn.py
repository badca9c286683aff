"""DnCNN: a plain conv stack predicting the noise residual.

The PyTorch counterpart of ``tpuir/models/dncnn.py`` (the Flax module),
after KAIR's ``network_dncnn.py``: ``nb`` 3x3 convs of width ``nc`` with a
ReLU between (batch norm is merged into the released weights), output
``x - f(x)``. The convs live in one ``nn.Sequential`` at ``model.{2i}``,
the released checkpoints' keys, so ``load_state_dict`` reads a released
``.pth`` as it is.

In parity the input is float32. In serving precision the engine hands the
net a bf16 chunk (``compute_dtype="bfloat16"``); the convs run on it
widened to float32 (under cuDNN's TF32, the engine pinning nothing) and
the residual is taken in bf16, ``x - n.to(x.dtype)``, where the JAX
module rounds (``tpuir/models/dncnn.py:28,37``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from tpuir_torch.utils.misc import seeded_state_dict


class DnCNN(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64, nb: int = 17):
        super().__init__()
        layers = [nn.Conv2d(in_nc, nc, 3, padding=1), nn.ReLU(inplace=True)]
        for _ in range(nb - 2):
            layers += [nn.Conv2d(nc, nc, 3, padding=1), nn.ReLU(inplace=True)]
        layers.append(nn.Conv2d(nc, out_nc, 3, padding=1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.model(x.float())
        return x - n.to(x.dtype)


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's DnCNN params as a torch state dict: the exact
    inverse of ``tpuir.models.dncnn.convert_state_dict`` (conv i's HWIO
    kernel as OIHW at ``model.{2i}``)."""
    p = params["params"] if "params" in params else params
    sd = {}
    for i in range(len(p)):
        node = p[f"conv{i}"]
        sd[f"model.{2 * i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)))
        sd[f"model.{2 * i}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
    return sd


def init_state_dict(in_nc: int = 1, nb: int = 17, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``DnCNN(in_nc, in_nc, 64, nb)``: He-scaled
    hidden convs, the last conv scaled down to a small residual."""
    with torch.device("meta"):
        net = DnCNN(in_nc, in_nc, 64, nb)
    last = f"model.{2 * (nb - 1)}.weight"
    return seeded_state_dict(net, seed, lambda n: 0.1 if n == last else np.sqrt(2.0))
