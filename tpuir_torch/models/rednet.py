"""REDNet: a 30-layer conv encoder-decoder with symmetric skips.

The PyTorch counterpart of ``tpuir/models/rednet.py`` (the Flax module),
laid out as the original: 15 3x3 convs ``conv1..conv15`` and 15
``ConvTranspose2d(k3, s1, p1)`` ``deconv1..deconv15``, so the converted
caffe blobs (conv OIHW, deconv (in, out, kh, kw)) and the released ``.pt``
load as they are. After deconv k (and its ReLU), for odd k, the encoder's
c_(15-k) is added and the sum re-ReLU'd; the output is
``deconv15(y) + x``. Each deconv runs as the correlation it equals (its
kernel flipped, in and out swapped), as the JAX module runs it: on the
card, cuDNN's transposed-conv algorithm in float32 at batch 1 is not
deterministic (one input gave two outputs on an H100), its forward convs
are.

In true float32 on the card (the engine's parity pin) a batch runs one
image at a time: with TF32 off, cuDNN's choice for a batch of these
128-channel 128x128 convs takes 254 ms a forward at batch 8 against 40 ms
for 8 single images (``python -m tpuir_torch.utils.profiling --model
rednet --layouts``, H100); under TF32 the batch is faster and runs whole.

Serving precision rounds where the JAX module does
(``tpuir/models/rednet.py:31,50``): the engine hands the net a bf16 chunk,
the layers run on it widened to float32 (cuDNN at TF32) and the output
residual is added in bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.utils.misc import float32_pinned, seeded_state_dict


class REDNet(nn.Module):
    def __init__(self, num_channels: int = 1, num_features: int = 128):
        super().__init__()
        nf = num_features
        for i in range(1, 16):
            setattr(self, f"conv{i}", nn.Conv2d(num_channels if i == 1 else nf, nf, 3, padding=1))
        for i in range(1, 16):
            setattr(self, f"deconv{i}",
                    nn.ConvTranspose2d(nf, num_channels if i == 15 else nf, 3, stride=1, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if float32_pinned(x) and x.shape[0] > 1:
            return torch.cat([self._forward(x[i:i + 1]) for i in range(x.shape[0])])
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()
        enc = {}
        for i in range(1, 16):
            y = F.relu(getattr(self, f"conv{i}")(y))
            if i % 2 == 0:  # c2, c4, ..., c14 meet deconv 13, 11, ..., 1
                enc[i] = y
        for k in range(1, 15):
            y = F.relu(_deconv(getattr(self, f"deconv{k}"), y))
            if k % 2 == 1:
                y = F.relu(y + enc[15 - k])
        return _deconv(self.deconv15, y).to(x.dtype) + x


def _deconv(deconv: nn.ConvTranspose2d, y: torch.Tensor) -> torch.Tensor:
    """``deconv(y)`` (k3, s1, p1) as a correlation: the kernel (in, out, kh,
    kw) flipped in space and read as (out, in)."""
    return F.conv2d(y, deconv.weight.transpose(0, 1).flip(2, 3), deconv.bias, padding=1)


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's REDNet params as a torch state dict: the exact
    inverse of ``tpuir.models.rednet.convert_state_dict`` (a conv's HWIO
    kernel as OIHW; a deconv's correlation kernel (kh, kw, in, out) back to
    the transposed conv's (in, out, kh, kw), spatially flipped)."""
    p = params["params"] if "params" in params else params
    sd = {}
    for name, node in p.items():
        k = np.asarray(node["kernel"], np.float32)
        w = (k.transpose(3, 2, 0, 1) if name.startswith("conv")
             else k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
    return sd


def init_state_dict(num_channels: int = 1, num_features: int = 128, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``REDNet(num_channels, num_features)``:
    layers scaled by 1/sqrt(fan_in) (the skips keep the activations up),
    deconv15 scaled down to a residual of about 0.1 on inputs in [0, 1]."""
    with torch.device("meta"):
        net = REDNet(num_channels, num_features)
    return seeded_state_dict(net, seed, lambda n: 0.1 if n == "deconv15.weight" else 1.0)
