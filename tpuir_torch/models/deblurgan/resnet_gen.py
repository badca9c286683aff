"""DeblurGAN's (v1-style) ResNet generator.

The PyTorch counterpart of ``tpuir/models/deblurgan/resnet_gen.py``
(``g_name: resnet``): a reflect-padded 7x7 stem, two stride-2 downsamples,
``n_blocks`` residual blocks, two ``ConvTranspose2d(k3, s2, p1,
output_padding=1)`` upsamples (weights in torch's (in, out, kh, kw), as
tpuir keeps them), a reflect-padded 7x7 head, tanh, and with
``learn_residual`` the input added and the sum clamped to [-1, 1]. Norms
are ``TrainNorm`` (per-sample moments; affine for ``norm='batch'``), conv
biases only with instance norm. Module names are the original's
``model.N`` Sequential slots (``model.{10+i}.conv_block.N`` for the
blocks), so a released state dict loads through ``norms.load_checkpoint``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

from tpuir_torch.utils.misc import seeded_state_dict

from .norms import TrainNorm, _vec, build_on, put_conv, put_norm


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        bias, affine = norm == "instance", norm == "batch"
        block = [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=bias),
                 TrainNorm(dim, affine=affine), nn.ReLU()]
        if use_dropout:
            block.append(nn.Dropout(0.5))
        block += [nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=bias),
                  TrainNorm(dim, affine=affine)]
        self.conv_block = nn.Sequential(*block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 norm: str = "instance", use_dropout: bool = False, n_blocks: int = 6,
                 learn_residual: bool = True):
        super().__init__()
        self.learn_residual = learn_residual
        bias, affine = norm == "instance", norm == "batch"
        model = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7, bias=bias),
                 TrainNorm(ngf, affine=affine), nn.ReLU()]
        for i in range(2):
            mult = 2 ** i
            model += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1, bias=bias),
                      TrainNorm(ngf * mult * 2, affine=affine), nn.ReLU()]
        model += [ResnetBlock(ngf * 4, norm, use_dropout) for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            model += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                                         output_padding=1, bias=bias),
                      TrainNorm(ngf * mult // 2, affine=affine), nn.ReLU()]
        model += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.model(x)
        if self.learn_residual:
            y = torch.clamp(x + y, -1.0, 1.0)
        return y


def state_dict_from_jax(params: Mapping[str, Any], n_blocks: int = 6,
                        use_dropout: bool = False) -> Dict[str, torch.Tensor]:
    """tpuir's ``ResnetGenerator`` params (instance norm, the layout its
    converter reads) as this module's state dict: the inverse of
    ``tpuir.models.deblurgan.resnet_gen.convert_state_dict``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def conv_norm(slot, node):
        put_conv(sd, f"model.{slot}", node)
        put_norm(sd, f"model.{slot + 1}", node["kernel"].shape[-1])

    conv_norm(1, p["stem"])
    conv_norm(4, p["down0"])
    conv_norm(7, p["down1"])
    c2 = 6 if use_dropout else 5
    for i in range(n_blocks):
        base = f"model.{10 + i}.conv_block"
        for slot, name in ((1, "conv1"), (c2, "conv2")):
            put_conv(sd, f"{base}.{slot}", p[f"block{i}"][name])
            put_norm(sd, f"{base}.{slot + 1}", p[f"block{i}"][name]["kernel"].shape[-1])
    for i in range(2):
        slot = 10 + n_blocks + 3 * i
        sd[f"model.{slot}.weight"] = _vec(p[f"up{i}_kernel"])
        if f"up{i}_bias" in p:
            sd[f"model.{slot}.bias"] = _vec(p[f"up{i}_bias"])
        put_norm(sd, f"model.{slot + 1}", p[f"up{i}_kernel"].shape[1])
    put_conv(sd, f"model.{17 + n_blocks}", p["head"])
    return sd


def init_state_dict(seed: int = 0, **config) -> Dict[str, torch.Tensor]:
    """A seeded state dict for ``ResnetGenerator(**config)``."""
    with torch.device("meta"):
        net = ResnetGenerator(**config)
    return seeded_state_dict(net, seed)


def build(state_dict=None, device="cuda", seed: int = 0, **config) -> ResnetGenerator:
    """``ResnetGenerator(**config)`` with ``state_dict`` (else seeded
    weights) on ``device`` (default card 0; raises without one)."""
    return build_on(device, lambda: ResnetGenerator(**config),
                     init_state_dict(seed, **config) if state_dict is None else state_dict)
