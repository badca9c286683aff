"""Architecture registry: ``network_g`` option dicts -> the port's ``nn.Module``s.

Takes the option files' keyword surface as ``tpuir/train/archs.py`` does
(type and key names of Restormer's and MaIR's option YAMLs, BasicSR's
registry convention) and builds the port's models with tpuir's choice of
variant: Restormer plain (``fused=False``: tpuir trains
``models/restormer.py``, not the K1 model), MaIR and MaIRUNet with
``fused=True`` (tpuir's mixer takes its kernels: K6, K2, K7, and K5 or K3
off the stripe route, each differentiable through ``ops/kernel_grad.py``).
Released ``.pth`` files load with ``load_state_dict``, so no converter is
needed. ``init_state_dict`` gives a network's seeded weights: the model
module's own ``init_state_dict`` where it has one for that configuration,
else PyTorch's default initialisation under the seed.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpuir_torch.registry import ARCH_REGISTRY


@ARCH_REGISTRY.register()
def DnCNN(in_nc=1, out_nc=1, nc=64, nb=17, act_mode="R", **kw):
    from tpuir_torch.models.dncnn import DnCNN as M

    return M(in_nc=in_nc, out_nc=out_nc, nc=nc, nb=nb)


@ARCH_REGISTRY.register()
def REDNet(num_channels=1, num_features=128, **kw):
    from tpuir_torch.models.rednet import REDNet as M

    return M(num_channels=num_channels, num_features=num_features)


def _restormer_config(inp_channels=3, out_channels=3, dim=48, num_blocks=(4, 6, 6, 8),
                      num_refinement_blocks=4, heads=(1, 2, 4, 8), ffn_expansion_factor=2.66,
                      bias=False, LayerNorm_type="WithBias", dual_pixel_task=False, **kw):
    return dict(inp_channels=inp_channels, out_channels=out_channels, dim=dim,
                num_blocks=tuple(num_blocks), num_refinement_blocks=num_refinement_blocks,
                heads=tuple(heads), ffn_expansion_factor=ffn_expansion_factor, bias=bias,
                layer_norm_bias=(LayerNorm_type == "WithBias"),
                dual_pixel_task=dual_pixel_task)


@ARCH_REGISTRY.register()
def Restormer(**kw):
    from tpuir_torch.models.restormer import Restormer as M

    return M(**_restormer_config(**kw), fused=False)


def _mair_config(in_chans=3, embed_dim=180, depths=(6, 6, 6, 6, 6, 6), d_state=16,
                 ssm_ratio=1.3, mlp_ratio=2.0, scan_len=4, img_range=1.0, upsampler=None,
                 **kw):
    if upsampler not in (None, "", "~"):
        raise NotImplementedError(
            "MaIR is ported for restoration (upsampler=None); SR upsamplers are not part "
            "of tpuir's test matrix")
    return dict(in_chans=in_chans, embed_dim=embed_dim, depths=tuple(depths),
                d_state=d_state, ssm_ratio=ssm_ratio, mlp_ratio=mlp_ratio,
                scan_len=scan_len, img_range=img_range)


@ARCH_REGISTRY.register()
def MaIR(**kw):
    from tpuir_torch.models.mair import MaIR as M

    return M(**_mair_config(**kw), fused=True)


def _mair_unet_config(inp_channels=3, out_channels=3, dim=48, num_blocks=(4, 6, 6, 8),
                      num_refinement_blocks=4, ssm_ratio=2.0, flp_ratio=4.0, mlp_ratio=1.5,
                      bias=False, dual_pixel_task=False, scan_len=4, **kw):
    return dict(inp_channels=inp_channels, out_channels=out_channels, dim=dim,
                num_blocks=tuple(num_blocks), num_refinement_blocks=num_refinement_blocks,
                ssm_ratio=ssm_ratio, flp_ratio=flp_ratio, mlp_ratio=mlp_ratio, bias=bias,
                dual_pixel_task=dual_pixel_task, scan_len=scan_len)


@ARCH_REGISTRY.register()
def MaIRUNet(**kw):
    from tpuir_torch.models.mair_unet import MaIRUNet as M

    return M(**_mair_unet_config(**kw), fused=True)


def build_network(opt: Dict) -> torch.nn.Module:
    """network_g dict -> the port's module, on the CPU."""
    opt = dict(opt)
    return ARCH_REGISTRY.get(opt.pop("type"))(**opt)


def init_state_dict(opt: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded weights for the network of the ``network_g`` dict ``opt``."""
    from tpuir_torch.models import mair, mair_unet, restormer

    opt = dict(opt)
    kind = opt.pop("type")
    if kind == "MaIR":
        return mair.init_state_dict(_mair_config(**opt), seed)
    if kind == "MaIRUNet":
        return mair_unet.init_state_dict(_mair_unet_config(**opt), seed)
    if kind == "Restormer":
        return restormer.init_state_dict(_restormer_config(**opt), seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return ARCH_REGISTRY.get(kind)(**opt).state_dict()
