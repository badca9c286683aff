"""K6: the MaIR mixer's prologue, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_prologue.py:mixer_prologue``: in_proj,
then a 3x3 depthwise conv + bias + SiLU on the x half; the z half passes
untouched. The kernel is ``tpuir_torch/csrc/nss_prologue.cu``; its source
note gives what bounds it on the card and what the design does about that.
Unlike the TPU kernel it pads no channels and emits no transposed copy.

``mixer_prologue`` is the wrapper: it checks its inputs and raises on
anything the kernel does not take. On a CUDA tensor it launches the kernel
on the current stream and counts the launch; on a CPU tensor, and only
there, it runs ``mixer_prologue_plain``, the same math in plain PyTorch,
which is also what the kernel is held against on the card.

Activations are channels-last: h is (B, H, W, d_model) contiguous; x and z
come back as (B, H, W, d_inner) contiguous. Weights are in PyTorch's
layouts: ``w_in`` (2*d_inner, d_model) (an ``nn.Linear`` weight, rows
[x | z]), ``conv_w`` (d_inner, 1, 3, 3), ``conv_b`` (d_inner,).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels


def _check(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
           conv_b: torch.Tensor) -> int:
    """Validate the inputs; return d_inner."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mixer_prologue: unsupported device {h.device}")
    if h.dtype != torch.float32:
        raise TypeError(f"mixer_prologue: float32 only, got {h.dtype}")
    if h.dim() != 4 or not h.is_contiguous():
        raise ValueError(f"mixer_prologue: h must be contiguous (B, H, W, C), got {tuple(h.shape)}")
    dm = h.shape[-1]
    di = conv_w.shape[0]
    want = {"w_in": (w_in, (2 * di, dm)), "conv_w": (conv_w, (di, 1, 3, 3)),
            "conv_b": (conv_b, (di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mixer_prologue: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != h.device or not t.is_contiguous():
            raise ValueError(f"mixer_prologue: {name} must be contiguous float32 on {h.device}")
    return di


def mixer_prologue_plain(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                         conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z) in plain PyTorch. On a card, turn TF32 off first (cuBLAS and
    cuDNN) for a float32 reference."""
    di = conv_w.shape[0]
    xz = F.linear(h, w_in)
    x = F.conv2d(xz[..., :di].permute(0, 3, 1, 2), conv_w, conv_b, padding=1, groups=di)
    return F.silu(x).permute(0, 2, 3, 1).contiguous(), xz[..., di:].contiguous()


def mixer_prologue(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. Forward only, float32 only."""
    di = _check(h, w_in, conv_w, conv_b)
    if h.device.type == "cpu":
        return mixer_prologue_plain(h, w_in, conv_w, conv_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w_in, conv_w, conv_b)):
        raise RuntimeError("mixer_prologue: the CUDA kernel has no backward")
    B, H, W, dm = h.shape
    lib = _kernels.library()
    with torch.cuda.device(h.device):
        xpre = torch.empty(B, H, W, di, device=h.device, dtype=torch.float32)
        x = torch.empty_like(xpre)
        z = torch.empty_like(xpre)
        err = lib.tpuir_mixer_prologue_f32(
            h.data_ptr(), w_in.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            xpre.data_ptr(), x.data_ptr(), z.data_ptr(), B, H, W, dm, di,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    _kernels.check(err, "mixer_prologue")
    _kernels.LAUNCHES["mixer_prologue"] += 1
    return x, z
