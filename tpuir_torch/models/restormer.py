"""Restormer: 4-level U-Net transformer with MDTA channel attention and GDFN.

The PyTorch counterpart of ``tpuir/models/restormer.py`` (the Flax module)
and ``tpuir/models/restormer_fused.py`` (every block through K1). Modules
are NCHW, activations are kept in ``torch.channels_last`` memory format,
and parameter names are the released checkpoints' (upstream Restormer), so
``load_state_dict`` reads a released ``.pth``'s ``params`` as it is.

The constructor's ``fused`` argument chooses how every TransformerBlock
runs: through the K1 wrapper (``tpuir_torch.ops.fused_block``; the zoo's
choice) or through the plain ``nn.Module`` composition below. Convolutions
outside the blocks are ``F.conv2d`` in both modes.

``serving=True`` is the counterpart of ``tpuir/models/restormer_fused.py``
with ``mm_bf16=True, io_bf16=True, fast_gelu=True``: patch_embed runs in
float32 and is cast to bf16; every other convolution, pixel (un)shuffle and
concat runs in bf16 with bf16 copies of the weights; the blocks take K1's
serving body (``fused``) or its plain version; the output conv's bf16
result is widened and the float32 input added. The parameters stay float32,
so a released ``.pth`` loads as it is.

Fidelity notes (as for the Flax module):
  * LayerNorm acts over channels with biased variance and eps 1e-5; the
    BiasFree variant divides by sqrt(var) without subtracting the mean in
    the numerator.
  * q and k are L2-normalised over pixels with eps 1e-12 (F.normalize).
  * GELU is the exact erf form.
  * Down/Upsample use pixel (un)shuffle's own channel order.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.ops.fused_block import (
    fused_transformer_block,
    fused_transformer_block_serving_plain,
)


class BiasFreeLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):  # x: (..., C)
        var = x.var(-1, keepdim=True, unbiased=False)
        return x / torch.sqrt(var + 1e-5) * self.weight


class WithBiasLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):  # x: (..., C)
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.weight + self.bias


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of an NCHW tensor (upstream ``LayerNorm``)."""

    def __init__(self, dim: int, use_bias: bool):
        super().__init__()
        self.body = WithBiasLayerNorm(dim) if use_bias else BiasFreeLayerNorm(dim)

    def forward(self, x):
        return self.body(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MDTA(nn.Module):
    """Multi-DConv-head transposed (C x C) self-attention."""

    def __init__(self, dim: int, num_heads: int, bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        # 'b (head c) h w -> b head c (h w)': channels are head-major
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w) for t in (q, k, v))
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = ((q @ k.transpose(-2, -1)) * self.temperature).softmax(dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class GDFN(nn.Module):
    """Gated-DConv feed-forward network."""

    def __init__(self, dim: int, expansion: float, bias: bool):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1, groups=hidden * 2, bias=bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=bias)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float, bias: bool,
                 ln_bias: bool, fused: bool, serving: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.ln_bias = ln_bias
        self.fused = fused
        self.serving = serving
        self.norm1 = ChannelLayerNorm(dim, ln_bias)
        self.attn = MDTA(dim, num_heads, bias)
        self.norm2 = ChannelLayerNorm(dim, ln_bias)
        self.ffn = GDFN(dim, expansion, bias)

    def forward(self, x):
        if self.fused or self.serving:
            args = (x.contiguous(memory_format=torch.channels_last),
                    dict(self.named_parameters()), self.num_heads, self.ln_bias)
            if self.fused:
                return fused_transformer_block(*args, serving=self.serving)
            return fused_transformer_block_serving_plain(*args)
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, embed_dim: int, bias: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=bias)

    def forward(self, x):
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False),
                                  nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False),
                                  nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class Restormer(nn.Module):
    def __init__(
        self,
        inp_channels: int = 3,
        out_channels: int = 3,
        dim: int = 48,
        num_blocks: Sequence[int] = (4, 6, 6, 8),
        num_refinement_blocks: int = 4,
        heads: Sequence[int] = (1, 2, 4, 8),
        ffn_expansion_factor: float = 2.66,
        bias: bool = False,
        layer_norm_bias: bool = True,  # WithBias (deblurring) vs BiasFree (denoising)
        dual_pixel_task: bool = False,
        fused: bool = False,
        serving: bool = False,
    ):
        super().__init__()
        nb, hd = num_blocks, heads
        self.serving = serving

        def blocks(n, d, h):
            return nn.Sequential(*[
                TransformerBlock(d, h, ffn_expansion_factor, bias, layer_norm_bias, fused,
                                 serving)
                for _ in range(n)
            ])

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim)
        self.encoder_level1 = blocks(nb[0], dim, hd[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = blocks(nb[1], dim * 2, hd[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = blocks(nb[2], dim * 4, hd[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = blocks(nb[3], dim * 8, hd[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=bias)
        self.decoder_level3 = blocks(nb[2], dim * 4, hd[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=bias)
        self.decoder_level2 = blocks(nb[1], dim * 2, hd[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = blocks(nb[0], dim * 2, hd[0])
        self.refinement = blocks(num_refinement_blocks, dim * 2, hd[0])
        self.dual_pixel_task = dual_pixel_task
        if dual_pixel_task:
            self.skip_conv = nn.Conv2d(dim, dim * 2, 1, bias=bias)
        self.output = nn.Conv2d(dim * 2, out_channels, 3, padding=1, bias=bias)

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)
        if self.serving:  # bf16 activations and convs, as restormer_fused.apply(io_bf16=True)
            act = torch.bfloat16
            feat1 = self.patch_embed(x).to(act)

            def conv(m, h):
                b = None if m.bias is None else m.bias.to(act)
                return F.conv2d(h, m.weight.to(act), b, m.stride, m.padding, m.dilation, m.groups)
        else:
            feat1 = self.patch_embed(x)

            def conv(m, h):
                return m(h)

        def down(m, h):
            return F.pixel_unshuffle(conv(m.body[0], h), 2)

        def up(m, h):
            return F.pixel_shuffle(conv(m.body[0], h), 2)

        e1 = self.encoder_level1(feat1)
        e2 = self.encoder_level2(down(self.down1_2, e1))
        e3 = self.encoder_level3(down(self.down2_3, e2))
        lat = self.latent(down(self.down3_4, e3))

        d3 = conv(self.reduce_chan_level3, torch.cat([up(self.up4_3, lat), e3], 1))
        d3 = self.decoder_level3(d3)
        d2 = conv(self.reduce_chan_level2, torch.cat([up(self.up3_2, d3), e2], 1))
        d2 = self.decoder_level2(d2)
        d1 = self.decoder_level1(torch.cat([up(self.up2_1, d2), e1], 1))
        d1 = self.refinement(d1)

        if self.dual_pixel_task:
            return conv(self.output, d1 + conv(self.skip_conv, feat1)).float()
        return conv(self.output, d1).float() + x


# ---------------------------------------------------------------------------
# Weights: from the JAX package's params, and seeded ones for tests and smoke
# runs. Both give state dicts in the released checkpoints' layout.
# ---------------------------------------------------------------------------

_RESAMPLE = ("down1_2", "down2_3", "down3_4", "up4_3", "up3_2", "up2_1")
_PLAIN_CONVS = ("reduce_chan_level3", "reduce_chan_level2", "skip_conv", "output")


def _hwio_to_oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Restormer params (numpy leaves) as a torch state dict.

    The exact inverse of ``tpuir.models.restormer.convert_state_dict``:
    HWIO kernels become OIHW (a depthwise (3, 3, 1, 3C) becomes (3C, 1, 3, 3)),
    and names go back to the released checkpoints' keys.
    """
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, node: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = _hwio_to_oihw(node["kernel"])
        if "bias" in node:
            sd[f"{prefix}.bias"] = _vec(node["bias"])

    for name, node in p.items():
        if name == "patch_embed":
            conv("patch_embed.proj", node)
        elif name in _RESAMPLE:
            conv(f"{name}.body.0", node["conv"])
        elif name in _PLAIN_CONVS:
            conv(name, node)
        else:  # a TransformerBlock, '<stage>_<i>'
            stage, i = name.rsplit("_", 1)
            t = f"{stage}.{i}"
            for n in ("norm1", "norm2"):
                for leaf, v in node[n].items():
                    sd[f"{t}.{n}.body.{leaf}"] = _vec(v)
            sd[f"{t}.attn.temperature"] = _vec(node["attn"]["temperature"])
            for c in ("qkv", "qkv_dwconv", "project_out"):
                conv(f"{t}.attn.{c}", node["attn"][c])
            for c in ("project_in", "dwconv", "project_out"):
                conv(f"{t}.ffn.{c}", node["ffn"][c])
    return sd


def init_block_params(dim: int, heads: int, ln_bias: bool, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """One TransformerBlock's parameters (GDFN expansion 2.66), drawn from
    RandomState(seed) and named relative to the block: unit-scale (fan-in
    scaled) weights for K1's tests."""
    hidden = int(dim * 2.66)
    rng = np.random.RandomState(seed)

    def conv(o, i, k):
        return rng.standard_normal((o, i, k, k)) / np.sqrt(i * k * k)

    p = {
        "norm1.body.weight": 1 + 0.1 * rng.standard_normal(dim),
        "norm2.body.weight": 1 + 0.1 * rng.standard_normal(dim),
        "attn.temperature": 0.5 + rng.rand(heads, 1, 1),
        "attn.qkv.weight": conv(3 * dim, dim, 1),
        "attn.qkv_dwconv.weight": conv(3 * dim, 1, 3),
        "attn.project_out.weight": conv(dim, dim, 1),
        "ffn.project_in.weight": conv(2 * hidden, dim, 1),
        "ffn.dwconv.weight": conv(2 * hidden, 1, 3),
        "ffn.project_out.weight": conv(dim, hidden, 1),
    }
    if ln_bias:
        p["norm1.body.bias"] = 0.1 * rng.standard_normal(dim)
        p["norm2.body.bias"] = 0.1 * rng.standard_normal(dim)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in p.items()}


# Branch outputs are scaled down so that a seeded network stays close to the
# identity: outputs then land inside [0, 1] like a trained model's, and a
# comparison of two paths in uint8 is not hidden by clipping.
_BRANCH_GAIN = 0.2
_OUTPUT_GAIN = 0.05


def init_state_dict(config: Optional[Mapping[str, Any]] = None, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """A full state dict for ``Restormer(**config)``, drawn from RandomState(seed).

    Conv weights are normals scaled by 1/sqrt(fan_in) (the blocks' output
    projections and the final conv further scaled down), LayerNorm weights
    lie near 1 and biases near 0, temperatures in [0.5, 1.5).
    """
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in Restormer(**(config or {})).state_dict().items()}
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name.endswith("temperature"):
            a = 0.5 + rng.rand(*shape)
        elif ".norm" in name:
            a = (1.0 if name.endswith("weight") else 0.0) + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            if name.endswith("project_out.weight"):
                a *= _BRANCH_GAIN
            elif name == "output.weight":
                a *= _OUTPUT_GAIN
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))
    return sd
