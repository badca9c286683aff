"""MaIRUNet: Restormer's U-Net skeleton with MaIR's Mamba mixers.

The PyTorch counterpart of ``tpuir/models/mair_unet.py`` (the Flax module),
the model of MaIR's real denoising and motion deblurring: a 3x3 patch
embed, four encoder levels of MaIR blocks joined by 3x3 convs with pixel
unshuffles, three decoder levels joined by 3x3 convs with pixel shuffles,
skip concatenations (reduced by 1x1 convs at levels 3 and 2), refinement
blocks, and a 3x3 output conv plus the input. Level i works at (H, W) / 2^i
with 2^i * dim channels and d_state base_d_state * 2^i, and every block
runs with the shift off.

It reuses ``models/mair.py``'s ``MaIRBlock`` (upstream's VSSBlock, the MLP
under ``mlp``), so each mixer takes the JAX package's route for its
level's (H, W) and its ``nss`` ("stripe", the default: K6 -> K2 -> K7
where H and W are even multiples of ``scan_len``; "fused": K5 where they
are multiples of it; "0": none of those), K3 on gathered sequences
elsewhere. ``fused`` picks the kernel wrappers or their plain versions, as
in ``MaIR``, and ``serving`` every mixer's serving precision (the JAX
module's ``scan_io_dtype="bfloat16"``: the serving bodies of K6, K2 and K7,
K5 or K3 on each level's route; see ``models/mair.py``), and ``recur_bf16``
K2's bf16-recurrence serving body on the stripe levels (the JAX module's
``TPUIR_RECUR_BF16=1``). Modules take NCHW
outside; the blocks run on contiguous NHWC (B, H, W, C) tensors, and the
convs see them as channels_last views. Parameter names are the released
checkpoints' (upstream MaIRUNet), so ``load_state_dict`` reads a released
``.pth``'s ``params``. The resampling modules are Restormer's (the same
upstream code): ``nn.PixelUnshuffle`` and ``nn.PixelShuffle`` have the
channel order of ``tpuir/ops/pixel_shuffle.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from tpuir_torch.models.mair import (MaIRBlock, _conv, _nchw, _nhwc, block_from_jax,
                                     seeded_state_dict)
from tpuir_torch.models.restormer import Downsample, OverlapPatchEmbed, Upsample


def _stage_forward(blocks: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    for blk in blocks:
        h = blk(h)
    return h


def _conv_nhwc(conv: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """A conv (or a resampling module) on NHWC h, NHWC contiguous out."""
    return _nhwc(conv(_nchw(h))).contiguous()


class MaIRUNet(nn.Module):
    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 ssm_ratio: float = 2.0, flp_ratio: float = 4.0, mlp_ratio: float = 1.5,
                 bias: bool = False, dual_pixel_task: bool = False, scan_len: int = 4,
                 base_d_state: int = 4, fused: bool = True, nss: str = "stripe",
                 serving: bool = False, recur_bf16: bool = False):
        super().__init__()
        nb, ds = num_blocks, base_d_state

        def stage(n, width, d_state, ratio):
            return nn.ModuleList([MaIRBlock(width, d_state, ssm_ratio, ratio, scan_len, fused,
                                            mlp_attr="mlp", nss=nss, serving=serving,
                                            recur_bf16=recur_bf16)
                                  for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim, bias)
        self.encoder_level1 = stage(nb[0], dim, ds, flp_ratio)
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = stage(nb[1], dim * 2, ds * 2, mlp_ratio)
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = stage(nb[2], dim * 4, ds * 4, mlp_ratio)
        self.down3_4 = Downsample(dim * 4)
        self.latent = stage(nb[3], dim * 8, ds * 8, mlp_ratio)
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=bias)
        self.decoder_level3 = stage(nb[2], dim * 4, ds * 4, mlp_ratio)
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=bias)
        self.decoder_level2 = stage(nb[1], dim * 2, ds * 2, mlp_ratio)
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = stage(nb[0], dim * 2, ds * 2, mlp_ratio)
        self.refinement = stage(num_refinement_blocks, dim * 2, ds * 2, mlp_ratio)
        self.dual_pixel_task = dual_pixel_task
        if dual_pixel_task:
            self.skip_conv = nn.Conv2d(dim, dim * 2, 1, bias=bias)
        self.output = nn.Conv2d(dim * 2, out_channels, 3, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, inp_channels, H, W) -> (B, out_channels, H, W)."""
        x = x.contiguous(memory_format=torch.channels_last)
        feat1 = self.patch_embed(x)
        e1 = _stage_forward(self.encoder_level1, _nhwc(feat1).contiguous())
        e2 = _stage_forward(self.encoder_level2, _conv_nhwc(self.down1_2, e1))
        e3 = _stage_forward(self.encoder_level3, _conv_nhwc(self.down2_3, e2))
        lat = _stage_forward(self.latent, _conv_nhwc(self.down3_4, e3))

        d3 = torch.cat([_conv_nhwc(self.up4_3, lat), e3], -1)
        d3 = _stage_forward(self.decoder_level3, _conv_nhwc(self.reduce_chan_level3, d3))
        d2 = torch.cat([_conv_nhwc(self.up3_2, d3), e2], -1)
        d2 = _stage_forward(self.decoder_level2, _conv_nhwc(self.reduce_chan_level2, d2))
        d1 = torch.cat([_conv_nhwc(self.up2_1, d2), e1], -1)
        d1 = _stage_forward(self.refinement, _stage_forward(self.decoder_level1, d1))

        if self.dual_pixel_task:
            return self.output(_nchw(d1) + self.skip_conv(feat1))
        return self.output(_nchw(d1)) + x


# ---------------------------------------------------------------------------
# Weights: from the JAX package's params, and seeded ones for tests and smoke
# runs. Both give state dicts in the released checkpoints' layout.
# ---------------------------------------------------------------------------

# the JAX package's names of the convs -> upstream's
_CONVS = {
    "patch_embed": "patch_embed.proj", "down1_2": "down1_2.body.0",
    "down2_3": "down2_3.body.0", "down3_4": "down3_4.body.0", "up4_3": "up4_3.body.0",
    "up3_2": "up3_2.body.0", "up2_1": "up2_1.body.0",
    "reduce_chan_level3": "reduce_chan_level3", "reduce_chan_level2": "reduce_chan_level2",
    "skip_conv": "skip_conv", "output": "output",
}


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's MaIRUNet params (numpy leaves) as a torch state dict.

    The exact inverse of ``tpuir.models.mair_unet.convert_state_dict``: HWIO
    kernels become OIHW under upstream's names, and each ``{stage}_{i}``
    block goes back to ``{stage}.{i}`` with its MLP under ``mlp``.
    """
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name in _CONVS:
            _conv(sd, _CONVS[name], node)
        else:  # {stage}_{i}
            stage, i = name.rsplit("_", 1)
            block_from_jax(sd, f"{stage}.{i}", node, "mlp")
    return sd


def init_state_dict(config: Optional[Mapping[str, Any]] = None, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """A full state dict for ``MaIRUNet(**config)``, drawn from
    RandomState(seed) as ``models/mair.py:init_state_dict`` draws MaIR's
    (the output conv scaled down like MaIR's conv_last)."""
    with torch.device("meta"):
        net = MaIRUNet(**(config or {}))
    return seeded_state_dict(net, seed, output="output.weight")
