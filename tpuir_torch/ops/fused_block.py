"""K1: one Restormer TransformerBlock, hand-written for Hopper.

The counterpart of ``tpuir/ops/fused_block.py:fused_transformer_block``.
The kernel is ``tpuir_torch/csrc/fused_block.cu``; its source note gives
the math, what bounds it on the card and what the design does about that.

``fused_transformer_block`` is the wrapper. It checks its inputs and raises
on anything the kernel does not take. On a CUDA tensor it launches the
kernel on the current stream and counts the launch; on a CPU tensor, and
only there, it runs ``fused_transformer_block_plain``, the same math in
plain PyTorch. The plain version is also what the kernel is compared with
on the card.

Activations are NCHW tensors in ``torch.channels_last`` memory format, so
each pixel's C channels are contiguous (the NHWC order of the JAX kernel).
``p`` holds the block's parameters under the released checkpoints' names,
relative to the block (``norm1.body.weight``, ``attn.qkv.weight``, ...), in
PyTorch's own layouts.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels

_WEIGHTS = (
    "norm1.body.weight", "norm2.body.weight", "attn.temperature",
    "attn.qkv.weight", "attn.qkv_dwconv.weight", "attn.project_out.weight",
    "ffn.project_in.weight", "ffn.dwconv.weight", "ffn.project_out.weight",
)
_CONV_BIASES = (
    "attn.qkv.bias", "attn.qkv_dwconv.bias", "attn.project_out.bias",
    "ffn.project_in.bias", "ffn.dwconv.bias", "ffn.project_out.bias",
)
_MAX_HEAD_WIDTH = 128  # the Gram and softmax kernels' limit


def _check(x: torch.Tensor, p: Mapping[str, torch.Tensor], heads: int,
           ln_bias: bool) -> int:
    """Validate the inputs; return the GDFN hidden width h."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_transformer_block: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_transformer_block: float32 only, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_transformer_block: x must be (B, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_transformer_block: x must be channels_last contiguous")
    biases = [k for k in _CONV_BIASES if k in p]
    if biases:
        raise ValueError(f"fused_transformer_block: conv biases are not supported: {biases}")
    names = _WEIGHTS + (("norm1.body.bias", "norm2.body.bias") if ln_bias else ())
    missing = [k for k in names if k not in p]
    if missing:
        raise KeyError(f"fused_transformer_block: missing parameters {missing}")
    B, C, H, W = x.shape
    if heads <= 0 or C % heads:
        raise ValueError(f"fused_transformer_block: C={C} not divisible by heads={heads}")
    hidden = p["ffn.project_out.weight"].shape[1]
    want = {
        "norm1.body.weight": (C,), "norm2.body.weight": (C,),
        "norm1.body.bias": (C,), "norm2.body.bias": (C,),
        "attn.temperature": (heads, 1, 1),
        "attn.qkv.weight": (3 * C, C, 1, 1),
        "attn.qkv_dwconv.weight": (3 * C, 1, 3, 3),
        "attn.project_out.weight": (C, C, 1, 1),
        "ffn.project_in.weight": (2 * hidden, C, 1, 1),
        "ffn.dwconv.weight": (2 * hidden, 1, 3, 3),
        "ffn.project_out.weight": (C, hidden, 1, 1),
    }
    for k in names:
        t = p[k]
        if tuple(t.shape) != want[k]:
            raise ValueError(f"fused_transformer_block: {k} has shape {tuple(t.shape)}, want {want[k]}")
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"fused_transformer_block: {k} must be contiguous float32 on {x.device}"
            )
    return hidden


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                ln_bias: bool) -> torch.Tensor:
    """Over the last axis; biased variance, eps 1e-5; BiasFree keeps x in the numerator."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu if ln_bias else x) * torch.rsqrt(var + 1e-5) * w
    return y + b if ln_bias else y


def fused_transformer_block_plain(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                                  heads: int, ln_bias: bool) -> torch.Tensor:
    """The block in plain PyTorch, step for step as the kernel computes it.

    x: (B, C, H, W) float32; returns a channels_last tensor of the same
    shape. On a card, turn TF32 off first (cuBLAS and cuDNN) for a float32
    reference.
    """
    B, C, H, W = x.shape
    hc = C // heads
    hidden = p["ffn.project_out.weight"].shape[1]
    xh = x.permute(0, 2, 3, 1)  # (B, H, W, C)

    y = _layer_norm(xh, p["norm1.body.weight"], p.get("norm1.body.bias"), ln_bias)
    qkv = y @ p["attn.qkv.weight"].reshape(3 * C, C).t()
    qkv = F.conv2d(qkv.permute(0, 3, 1, 2), p["attn.qkv_dwconv.weight"],
                   padding=1, groups=3 * C)
    q, k, v = qkv.reshape(B, 3, heads, hc, H * W).unbind(1)  # (B, heads, hc, HW)
    qn = q.square().sum(-1).sqrt().clamp_min(1e-12)
    kn = k.square().sum(-1).sqrt().clamp_min(1e-12)
    g = q @ k.transpose(-1, -2)
    logits = g / qn[..., :, None] / kn[..., None, :] * p["attn.temperature"].reshape(1, heads, 1, 1)
    ao = (logits.softmax(-1) @ v).reshape(B, C, H, W).permute(0, 2, 3, 1)
    x2 = xh + ao @ p["attn.project_out.weight"].reshape(C, C).t()

    y2 = _layer_norm(x2, p["norm2.body.weight"], p.get("norm2.body.bias"), ln_bias)
    h1 = y2 @ p["ffn.project_in.weight"].reshape(2 * hidden, C).t()
    h1 = F.conv2d(h1.permute(0, 3, 1, 2), p["ffn.dwconv.weight"],
                  padding=1, groups=2 * hidden)
    a1, a2 = h1.chunk(2, dim=1)
    gate = (F.gelu(a1) * a2).permute(0, 2, 3, 1)
    out = x2 + gate @ p["ffn.project_out.weight"].reshape(C, hidden).t()
    return out.permute(0, 3, 1, 2)


def fused_transformer_block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                            heads: int, ln_bias: bool) -> torch.Tensor:
    """One TransformerBlock: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. Forward only, float32 only, bias-free convs."""
    hidden = _check(x, p, heads, ln_bias)
    if x.device.type == "cpu":
        return fused_transformer_block_plain(x, p, heads, ln_bias)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in p.values())):
        raise RuntimeError("fused_transformer_block: the CUDA kernel has no backward")
    B, C, H, W = x.shape
    if C // heads > _MAX_HEAD_WIDTH:
        raise ValueError(f"fused_transformer_block: head width {C // heads} > {_MAX_HEAD_WIDTH}")

    lib = _kernels.library()
    n = B * H * W
    with torch.cuda.device(x.device):
        empty = lambda numel: torch.empty(numel, device=x.device, dtype=torch.float32)  # noqa: E731
        buf1 = empty(n * max(3 * C, 2 * hidden))
        hp = -(-hidden // 4) * 4  # the gate's row stride (csrc/fused_block.cu)
        buf2 = empty(n * max(3 * C, hp))
        x2 = empty(n * C)
        w_out_p = empty(C * hp)
        partials = empty(lib.tpuir_fused_block_partials_numel(B, H, W, C, heads))
        attn = empty(B * C * (C // heads))
        mt = empty(B * C * C)
        stats = empty(2 * n)  # per-pixel LayerNorm (mean, rstd)
        out = torch.empty_like(x)
        ln1_b = p["norm1.body.bias"].data_ptr() if ln_bias else None
        ln2_b = p["norm2.body.bias"].data_ptr() if ln_bias else None
        err = lib.tpuir_fused_block_f32(
            x.data_ptr(), out.data_ptr(),
            p["norm1.body.weight"].data_ptr(), ln1_b,
            p["norm2.body.weight"].data_ptr(), ln2_b,
            p["attn.qkv.weight"].data_ptr(), p["attn.qkv_dwconv.weight"].data_ptr(),
            p["attn.temperature"].data_ptr(), p["attn.project_out.weight"].data_ptr(),
            p["ffn.project_in.weight"].data_ptr(), p["ffn.dwconv.weight"].data_ptr(),
            p["ffn.project_out.weight"].data_ptr(),
            buf1.data_ptr(), buf2.data_ptr(), x2.data_ptr(), w_out_p.data_ptr(),
            partials.data_ptr(),
            attn.data_ptr(), mt.data_ptr(), stats.data_ptr(),
            B, H, W, C, heads, hidden, int(ln_bias),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _kernels.check(err, "fused_transformer_block")
    _kernels.LAUNCHES["fused_transformer_block"] += 1
    return out
