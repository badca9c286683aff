"""MaIR: Mamba-based image restoration, flat (SwinIR-style) denoising model.

The PyTorch counterpart of ``tpuir/models/mair.py`` (the Flax module),
MaIR-CDN's branch: conv_first -> LayerNorm -> residual groups of MaIR
blocks, each group closed by a 3x3 conv and a skip -> LayerNorm ->
conv_after_body + skip -> conv_last + the input, around a mean shift.
Modules take NCHW outside; the body runs on contiguous NHWC (B, H, W, C)
tensors, and the 3x3 convs see them as channels_last views. Parameter
names are the released checkpoints' (upstream MaIR), so
``load_state_dict`` reads a released ``.pth``'s ``params``.

The mixer (``SSMixer``, upstream VMM / LoSh2D) takes the JAX package's
three routes, chosen per level as ``tpuir/models/mair.py:196-213`` chooses
them under its ``TPUIR_NSS`` knob (the mixer's ``nss``: "stripe", the
default, "fused" or "0"); ``SSMixer.route`` names a level's route:

* the stripe route ("stripe", where H and W are even multiples of
  ``scan_len``): K6 (``ops/nss_prologue``) -> K2 (``ops/nss_stripe``) ->
  the gates -> K7 (``ops/nss_epilogue``);
* the fused route ("fused", where H and W are multiples of ``scan_len``):
  plain in_proj, depthwise conv and SiLU, K5 (``ops/nss_fused``), the gates
  from its pooled sums, the gated four-direction sum, out_norm, SiLU(z) and
  out_proj (``tpuir/models/mair.py:304-341`` and ``:389-397``);
* the sequence route on any other level (MaIRUNet's odd pyramid levels,
  and every level under "0"): plain in_proj, depthwise conv and SiLU, the
  gather along the four scan paths, K3 (``ops/scan_fused_proj``), the
  gates, the inverse gather and the sum over directions, out_norm, SiLU(z)
  and out_proj (``tpuir/models/mair.py:342-396``).

With ``fused=True`` (the zoo's choice) it calls the kernel wrappers, which
launch the CUDA kernels on a CUDA tensor and take their plain versions on a
CPU tensor; with ``fused=False`` it calls the plain versions on any device.
The gates are a tiny einsum, sigmoid(sum_i mean_i[b,d] * gw[d,o,i] +
gb[d,o]) over the directions' means of y, with the ShuffleAttn conv's
weight as gw (its channel shuffles collapse into the (d, o, i) indexing, as
in the JAX module), taken in true float32 whatever TF32 setting the caller
has (the JAX module's ``Precision.HIGHEST``). The 3x3 convs outside the
mixer, the blocks' LayerNorms and the MLP are plain PyTorch in both modes;
the body's convs run one image at a time on the card (``_body_conv``).

``serving=True`` is MaIR's serving precision, the JAX module's
``scan_io_dtype="bfloat16"``, on every route: the stripe route takes the
serving bodies of K6, K2 and K7 (bf16 x, z and y between them, bf16
products with float32 sums; see each wrapper); the fused route K5's (bf16
x in, bf16 y out, float32 pooled) and the sequence route K3's (bf16 xs in,
float32 y out) between plain float32 layers, with the JAX module's bf16
roundings around them (``tpuir/models/mair.py:304-396``): on the sequence
route y * gates rounded to bf16 before the inverse gather, and the sum
over the directions rounded once; on both, the serving tail (``_tail``:
out_norm's output and z rounded to bf16, ``silu_bf16``, their product
rounded, out_proj in float32 on the float32 weight). Every other layer
stays float32. The parameters stay float32 in both precisions, so a
released ``.pth`` loads as it is.

``recur_bf16=True`` (the JAX module's ``TPUIR_RECUR_BF16=1``) takes K2's
bf16-recurrence serving body on the stripe route, and only there and only
in serving precision, as ``tpuir/models/mair.py:248-254`` passes it: the
fused and sequence routes, and parity, ignore it. With ``fused=False`` the
stripe route takes its plain version, ``nss_scan_recur_plain``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.core.engine import true_float32
from tpuir_torch.ops.nss_epilogue import (mixer_epilogue, mixer_epilogue_plain,
                                          mixer_epilogue_serving_plain)
from tpuir_torch.ops.nss_fused import (nss_scan_fused, nss_scan_fused_plain,
                                       nss_scan_fused_serving_plain)
from tpuir_torch.ops.nss_prologue import (mixer_prologue, mixer_prologue_plain,
                                          mixer_prologue_serving_plain)
from tpuir_torch.ops.nss_stripe import (nss_scan, nss_scan_plain, nss_scan_recur_plain,
                                        nss_scan_serving_plain)
from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                             selective_scan_fused_proj_plain,
                                             selective_scan_fused_proj_serving_plain)
from tpuir_torch.ops.scan_ids import scan_index_tensors

K = 4  # scan directions
NSS_MODES = ("stripe", "fused", "0")  # the JAX module's TPUIR_NSS values


def _nchw(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def silu_bf16(z: torch.Tensor) -> torch.Tensor:
    """SiLU of a bf16 z, bf16 out, as XLA lowers ``jax.nn.silu`` on bf16 on
    the CPU: the sigmoid as 1 / (1 + exp(-z)) with every operation rounded
    to bf16, then z times it, rounded. PyTorch's bf16 arithmetic computes
    each operation in float32 and rounds it once, so each step below is
    that rounding. (``torch.sigmoid`` and ``F.silu`` on bf16 round the
    float32 result once: another function, a bf16 ulp away on many
    elements.)"""
    return z * torch.reciprocal(1 + torch.exp(-z))


def _body_conv(conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    """A body 3x3 conv on NHWC h, NHWC out; on the card one image at a time.

    In float32 without TF32, cuDNN's own choice for a batch of these
    180-channel 128x128 images is an FFT algorithm that takes 17.6 ms at
    batch 8 and 240-290 ms at batch 3-4, against 0.36 ms an image for its
    choice at batch 1 (``python -m tpuir_torch.utils.profiling``, H100).
    """
    x = _nchw(h)
    if x.device.type == "cuda" and x.shape[0] > 1:
        return _nhwc(torch.cat([conv(x[i:i + 1]) for i in range(x.shape[0])]))
    return _nhwc(conv(x))


class ShuffleAttn(nn.Module):
    """Holds the ShuffleAttn gate's grouped 1x1 conv under its upstream
    name (``gating.1``); the mixer applies it as the (d, o, i) einsum."""

    def __init__(self, d_inner: int):
        super().__init__()
        self.gating = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(K * d_inner, K * d_inner, 1, groups=d_inner),
            nn.Sigmoid(),
        )


class SSMixer(nn.Module):
    """VMM: the 4-direction NSS selective-scan mixer with the shuffle gate."""

    def __init__(self, d_model: int, d_state: int = 16, expand: float = 2.0,
                 scan_len: int = 4, fused: bool = True, nss: str = "stripe",
                 serving: bool = False, recur_bf16: bool = False):
        super().__init__()
        if nss not in NSS_MODES:
            raise ValueError(f"nss must be one of {NSS_MODES}, got {nss!r}")
        self.serving = serving
        # the bf16 recurrence is a serving body of the stripe route's K2 only
        self.recur_bf16 = serving and recur_bf16
        self.d_inner = d_inner = int(expand * d_model)
        self.dt_rank = math.ceil(d_model / 16)
        self.d_state = d_state
        self.scan_len = scan_len
        self.fused = fused
        self.nss = nss
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, 3, padding=1, groups=d_inner)
        self.x_proj_weight = nn.Parameter(torch.zeros(K, self.dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.zeros(K, d_inner, self.dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.zeros(K, d_inner))
        self.A_logs = nn.Parameter(torch.zeros(K * d_inner, d_state))
        self.Ds = nn.Parameter(torch.ones(K * d_inner))
        self.gating = ShuffleAttn(d_inner)
        self.out_norm = nn.LayerNorm(d_inner)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def route(self, H: int, W: int) -> str:
        """The route of an (H, W) level: "stripe" (K6 -> K2 -> K7), "fused"
        (K5) or "sequence" (K3), as the JAX module picks it under
        ``TPUIR_NSS=self.nss`` (``tpuir/models/mair.py:196-213``)."""
        sl = self.scan_len
        if H % sl or W % sl:
            return "sequence"
        if self.nss == "stripe" and H % 2 == 0 and W % 2 == 0:
            return "stripe"
        return "sequence" if self.nss == "0" else "fused"

    def _gates(self, mean: torch.Tensor) -> torch.Tensor:
        """(B, K, d_inner) gates from the directions' means of y (B, K, d_inner)."""
        di = self.d_inner
        conv = self.gating.gating[1]
        gw = conv.weight.reshape(di, K, K)
        gb = conv.bias.reshape(di, K)
        with true_float32():
            g = torch.einsum("bid,doi->bod", mean, gw)
        return torch.sigmoid(g + gb.t()[None]).contiguous()

    def forward(self, h: torch.Tensor, shift: bool = False) -> torch.Tensor:
        """h: (B, H, W, d_model) -> (B, H, W, d_model)."""
        B, H, W, _ = h.shape
        di, n = self.d_inner, self.d_state
        A = -torch.exp(self.A_logs).reshape(K, di, n)
        scan_w = (self.x_proj_weight, self.dt_projs_weight, A, self.Ds.reshape(K, di),
                  self.dt_projs_bias)
        route = self.route(H, W)
        if route == "sequence":
            return self._sequence_route(h, shift, scan_w)
        if route == "fused":
            return self._fused_route(h, shift, scan_w)
        if self.fused:
            prologue, epilogue = (functools.partial(f, serving=self.serving)
                                  for f in (mixer_prologue, mixer_epilogue))
            scan = functools.partial(nss_scan, serving=self.serving, recur_bf16=self.recur_bf16)
        elif self.serving:
            prologue, scan, epilogue = (
                mixer_prologue_serving_plain,
                nss_scan_recur_plain if self.recur_bf16 else nss_scan_serving_plain,
                mixer_epilogue_serving_plain)
        else:
            prologue, scan, epilogue = mixer_prologue_plain, nss_scan_plain, mixer_epilogue_plain
        x, z = prologue(h.contiguous(), self.in_proj.weight, self.conv2d.weight,
                        self.conv2d.bias)
        y, pooled = scan(x, *scan_w, self.scan_len, shift)
        gates = self._gates(pooled / (H * W))
        return epilogue(y, gates, z, self.out_norm.weight, self.out_norm.bias,
                        self.out_proj.weight)

    def _tail(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """out_norm, the SiLU(z) gate and out_proj of the fused and sequence
        routes (``tpuir/models/mair.py:389-396``) on y, z (B, L, d_inner)
        float32. In serving: bf16(out_norm(y)) * silu_bf16(bf16(z)), rounded
        to bf16, then out_proj in float32 on the widened values and the
        float32 weight (flax ``Dense``'s promotion, with no weight rounding)."""
        if not self.serving:
            return self.out_proj(self.out_norm(y) * F.silu(z))
        g = silu_bf16(z.to(torch.bfloat16))
        return self.out_proj((self.out_norm(y).to(torch.bfloat16) * g).float())

    def _fused_route(self, h: torch.Tensor, shift: bool, scan_w) -> torch.Tensor:
        """Plain layers around K5 (``tpuir/models/mair.py:304-341``, ``:389-397``);
        in serving, K5's serving body on x rounded to bf16 and the gated sum
        in float32 over its widened bf16 y."""
        B, H, W, _ = h.shape
        L, di = H * W, self.d_inner
        x, z = self.in_proj(h).split(di, -1)
        # batched, unlike the body convs: cuDNN's float32 depthwise conv is
        # faster on the batch than one image at a time at every level (PERF.md)
        x = _nhwc(F.silu(self.conv2d(_nchw(x)))).contiguous()
        if self.serving:
            x = x.to(torch.bfloat16)
            scan = (functools.partial(nss_scan_fused, serving=True) if self.fused
                    else nss_scan_fused_serving_plain)
        else:
            scan = nss_scan_fused if self.fused else nss_scan_fused_plain
        y01, y23, pooled = scan(x, *scan_w, self.scan_len, shift)
        g = self._gates(pooled / L)[:, :, None, None]  # (B, K, 1, 1, d_inner)
        # the four directions back in image layout, gated and summed (in
        # float32: a bf16 y widens where it meets the float32 gates)
        y = (y01[:, 0] * g[:, 0] + y01[:, 1] * g[:, 1]
             + y23[:, 0].transpose(1, 2) * g[:, 2] + y23[:, 1].transpose(1, 2) * g[:, 3])
        return self._tail(y.reshape(B, L, di), z.reshape(B, L, di)).reshape(B, H, W, -1)

    def _sequence_route(self, h: torch.Tensor, shift: bool, scan_w) -> torch.Tensor:
        """Plain layers around K3 on gathered sequences (``tpuir/models/mair.py:342-396``);
        in serving, K3's serving body on xs rounded to bf16, y * gates rounded
        to bf16 before the inverse gather and the float32 sum over the
        directions rounded once."""
        B, H, W, _ = h.shape
        L, di = H * W, self.d_inner
        x, z = self.in_proj(h).split(di, -1)
        x = F.silu(self.conv2d(_nchw(x)))
        ids, inv = scan_index_tensors(H, W, self.scan_len, self.scan_len // 2 if shift else 0,
                                      h.device)
        xs = _nhwc(x).reshape(B, L, di)[:, ids]  # (B, K, L, d_inner), sequence order
        if self.serving:
            xs = xs.to(torch.bfloat16)
            scan = (functools.partial(selective_scan_fused_proj, serving=True) if self.fused
                    else selective_scan_fused_proj_serving_plain)
        else:
            scan = selective_scan_fused_proj if self.fused else selective_scan_fused_proj_plain
        y = scan(xs, *scan_w)
        y = y * self._gates(y.mean(2))[:, :, None]
        if self.serving:
            y = y.to(torch.bfloat16)
        # back to pixel order per direction, then the sum over directions (of
        # bf16 values: summed in float32, rounded once)
        y = torch.gather(y, 2, inv[None, :, :, None].expand(B, K, L, di)).sum(1)
        return self._tail(y.float(), z.reshape(B, L, di)).reshape(B, H, W, -1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class MaIRBlock(nn.Module):
    """RMB (MaIRUNet's VSSBlock): LN -> mixer with a learnable skip scale ->
    LN -> MLP with another. The MLP is ``conv_blk`` in MaIR's checkpoints
    and ``mlp`` in MaIRUNet's (``mlp_attr``)."""

    def __init__(self, dim: int, d_state: int, ssm_ratio: float, mlp_ratio: float,
                 scan_len: int = 4, fused: bool = True, mlp_attr: str = "conv_blk",
                 nss: str = "stripe", serving: bool = False, recur_bf16: bool = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim)
        self.self_attention = SSMixer(dim, d_state, ssm_ratio, scan_len, fused, nss, serving,
                                      recur_bf16)
        self.skip_scale = nn.Parameter(torch.ones(dim))
        self.ln_2 = nn.LayerNorm(dim)
        self.mlp_attr = mlp_attr
        self.add_module(mlp_attr, Mlp(dim, int(dim * mlp_ratio)))
        self.skip_scale2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, shift: bool = False) -> torch.Tensor:
        """x: (B, H, W, dim) -> (B, H, W, dim)."""
        x = x * self.skip_scale + self.self_attention(self.ln_1(x), shift)
        return x * self.skip_scale2 + getattr(self, self.mlp_attr)(self.ln_2(x))


class ResidualGroup(nn.Module):
    """Upstream's ``layers.{i}.residual_group.blocks`` holder."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RMG(nn.Module):
    """A residual group: blocks (odd ones on the shifted scan), a 3x3 conv, a skip."""

    def __init__(self, dim: int, depth: int, d_state: int, ssm_ratio: float,
                 mlp_ratio: float, scan_len: int, fused: bool, nss: str = "stripe",
                 serving: bool = False, recur_bf16: bool = False):
        super().__init__()
        self.residual_group = ResidualGroup(
            [MaIRBlock(dim, d_state, ssm_ratio, mlp_ratio, scan_len, fused, nss=nss,
                       serving=serving, recur_bf16=recur_bf16)
             for _ in range(depth)])
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        g = h
        for j, blk in enumerate(self.residual_group.blocks):
            h = blk(h, shift=bool(j % 2))
        return _body_conv(self.conv, h) + g


class PatchEmbed(nn.Module):
    """Only its LayerNorm survives: token <-> image moves are reshapes in NHWC."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class MaIR(nn.Module):
    """Flat MaIR for Gaussian color denoising (upsampler None, 1conv);
    ``serving`` takes the mixers' serving bodies, ``recur_bf16`` K2's
    bf16-recurrence one among them (see the module docstring)."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6), d_state: int = 16,
                 ssm_ratio: float = 1.3, mlp_ratio: float = 2.0, scan_len: int = 4,
                 img_range: float = 1.0, fused: bool = True, nss: str = "stripe",
                 serving: bool = False, recur_bf16: bool = False):
        super().__init__()
        self.img_range = img_range
        mean = [0.4488, 0.4371, 0.4040] if in_chans == 3 else [0.0] * in_chans
        self.register_buffer("mean", torch.tensor(mean).reshape(1, in_chans, 1, 1),
                             persistent=False)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([
            RMG(embed_dim, depth, d_state, ssm_ratio, mlp_ratio, scan_len, fused, nss, serving,
                recur_bf16)
            for depth in depths
        ])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_last = nn.Conv2d(embed_dim, in_chans, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, in_chans, H, W) -> (B, in_chans, H, W)."""
        x = (x - self.mean) * self.img_range
        xf = self.conv_first(x.contiguous(memory_format=torch.channels_last))
        h = self.patch_embed.norm(_nhwc(xf)).contiguous()
        for layer in self.layers:
            h = layer(h)
        h = self.norm(h)
        res = _nchw(_body_conv(self.conv_after_body, h)) + xf
        x = x + self.conv_last(res)
        return x / self.img_range + self.mean


# ---------------------------------------------------------------------------
# Weights: from the JAX package's params, and seeded ones for tests and smoke
# runs. Both give state dicts in the released checkpoints' layout.
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping[str, Any]) -> None:
    """An HWIO kernel (+ bias, where there is one) back to OIHW."""
    sd[f"{prefix}.weight"] = _t(np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1))
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _dense(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(node["kernel"], np.float32).T)
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _ln(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(node["weight"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _mixer_from_jax(sd: Dict[str, torch.Tensor], t: str, p: Mapping[str, Any]) -> None:
    di = np.asarray(p["gate_weight"]).shape[0]
    _dense(sd, f"{t}.in_proj", p["in_proj"])
    _conv(sd, f"{t}.conv2d", p["conv2d"])
    for name in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias"):
        sd[f"{t}.{name}"] = _t(p[name])
    sd[f"{t}.A_logs"] = _t(np.asarray(p["A_logs"]).reshape(K * di, -1))
    sd[f"{t}.Ds"] = _t(np.asarray(p["Ds"]).reshape(K * di))
    sd[f"{t}.gating.gating.1.weight"] = _t(np.asarray(p["gate_weight"]).reshape(K * di, K, 1, 1))
    sd[f"{t}.gating.gating.1.bias"] = _t(np.asarray(p["gate_bias"]).reshape(K * di))
    _ln(sd, f"{t}.out_norm", p["out_norm"])
    _dense(sd, f"{t}.out_proj", p["out_proj"])


def block_from_jax(sd: Dict[str, torch.Tensor], t: str, node: Mapping[str, Any],
                   mlp_attr: str) -> None:
    """One block's params (``tpuir.models.mair.convert_block``'s output) under prefix t."""
    _ln(sd, f"{t}.ln_1", node["ln_1"])
    _ln(sd, f"{t}.ln_2", node["ln_2"])
    sd[f"{t}.skip_scale"] = _t(node["skip_scale"])
    sd[f"{t}.skip_scale2"] = _t(node["skip_scale2"])
    _mixer_from_jax(sd, f"{t}.self_attention", node["self_attention"])
    _dense(sd, f"{t}.{mlp_attr}.fc1", node["mlp"]["fc1"])
    _dense(sd, f"{t}.{mlp_attr}.fc2", node["mlp"]["fc2"])


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's MaIR params (numpy leaves) as a torch state dict.

    The exact inverse of ``tpuir.models.mair.convert_state_dict``: HWIO
    kernels become OIHW, Dense kernels are transposed back, the gate and
    the (K, d_inner, ...) scan parameters are flattened back to upstream's
    (K*d_inner, ...), and names go back to the released checkpoints' keys.
    """
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name in ("conv_first", "conv_after_body", "conv_last"):
            _conv(sd, name, node)
        elif name in ("patch_embed_norm", "norm"):
            _ln(sd, "patch_embed.norm" if name == "patch_embed_norm" else "norm", node)
        elif name.endswith("_conv"):  # layers_{i}_conv
            _conv(sd, f"layers.{name.split('_')[1]}.conv", node)
        else:  # layers_{i}_blocks_{j}
            _, i, _, j = name.split("_")
            block_from_jax(sd, f"layers.{i}.residual_group.blocks.{j}", node, "conv_blk")
    return sd


# Branch outputs are scaled down so that a seeded network stays close to the
# identity: outputs then land inside [0, 1] like a trained model's, and a
# comparison of two paths in uint8 is not hidden by clipping.
_BRANCH_GAIN = 0.2
_OUTPUT_GAIN = 0.05


def init_state_dict(config: Optional[Mapping[str, Any]] = None, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """A full state dict for ``MaIR(**config)``, drawn from RandomState(seed).

    Linear and conv weights are normals scaled by 1/sqrt(fan_in) (the
    branch outputs, out_proj, fc2 and each group's conv, further scaled
    down, conv_last more so); LayerNorm weights and skip scales lie near 1,
    biases near 0. The scan parameters follow Mamba's initialisation:
    A_logs = log(1..N), D near 1, dt biases the inverse softplus of a step
    drawn log-uniformly from [1e-3, 1e-1].
    """
    with torch.device("meta"):
        net = MaIR(**(config or {}))
    return seeded_state_dict(
        net, seed, output="conv_last.weight",
        branch=lambda name: name.startswith("layers.") and name.endswith(".conv.weight"))


def seeded_state_dict(net: nn.Module, seed: int, output: str,
                      branch: Callable[[str], bool] = lambda name: False
                      ) -> Dict[str, torch.Tensor]:
    """``init_state_dict``'s draws for every entry of ``net``'s state dict
    (which may live on the meta device), in its order: ``output`` is the
    network's last conv, ``branch`` picks weights scaled like out_proj and
    fc2 beside those two."""
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "A_logs":
            a = np.tile(np.log(np.arange(1, shape[1] + 1, dtype=np.float64)), (shape[0], 1))
        elif leaf == "dt_projs_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            a = dt + np.log(-np.expm1(-dt))  # softplus^-1(dt)
        elif leaf in ("Ds", "skip_scale", "skip_scale2") or (
                leaf == "weight" and len(shape) == 1):  # LayerNorm weights
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias":
            a = (0.1 if "gating" in name else 0.02) * rng.standard_normal(shape)
        elif name.endswith("gating.gating.1.weight"):
            a = rng.standard_normal(shape) / 2.0
        else:
            fan_in = int(np.prod(shape[1:])) if leaf != "x_proj_weight" else shape[-1]
            if leaf == "dt_projs_weight":
                fan_in = shape[-1]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
            if name.endswith(("out_proj.weight", "fc2.weight")) or branch(name):
                a *= _BRANCH_GAIN
            elif name == output:
                a *= _OUTPUT_GAIN
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))
    return sd
