"""K6: the MaIR mixer's prologue, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_prologue.py:mixer_prologue``: in_proj,
then a 3x3 depthwise conv + bias + SiLU on the x half; the z half passes
untouched. The kernel is ``tpuir_torch/csrc/nss_prologue.cu``, in its two
bodies: float32 parity (``tpuir_mixer_prologue_f32``: in_proj on the GEMM
core, then the conv) and serving (``tpuir_mixer_prologue_bf16``, the TPU
kernel with ``serving=True``: in_proj of bf16-rounded h and W_in summed in
float32, the conv and SiLU in float32, x and z stored in bf16; one kernel
takes in_proj and the conv together on a tile of pixels and its halo, after
a small launch that rounds W_in to a bf16 copy); its source note gives what
bounds it on the card and what the design does about that. Unlike the TPU
kernel it pads no channels and emits no transposed copy.

``mixer_prologue`` is the wrapper: it checks its inputs and raises on
anything the kernel does not take. On a CUDA tensor it launches the kernel
on the current stream and counts the launch, under ``mixer_prologue`` or,
for the serving body, ``mixer_prologue_serving``; on a CPU tensor, and only
there, it runs ``mixer_prologue_plain`` or ``mixer_prologue_serving_plain``,
the same math in plain PyTorch, which is also what the kernel is held
against on the card. ``mixer_prologue_serving_stages`` returns the serving
body's bf16 copy of W_in and the float32 x half of in_proj (which the
kernel writes only there) beside its outputs, for the stage-by-stage check
of ``utils/serving_check.py``.

Activations are channels-last: h is (B, H, W, d_model) contiguous float32;
x and z come back as (B, H, W, d_inner) contiguous, float32 or, serving,
bf16. Weights are float32 in PyTorch's layouts: ``w_in`` (2*d_inner,
d_model) (an ``nn.Linear`` weight, rows [x | z]), ``conv_w`` (d_inner, 1,
3, 3), ``conv_b`` (d_inner,). The serving body's d_model, rounded up to
16, is at most ``MAX_SERVING_MODEL`` (its halo tile's shared memory).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels
from tpuir_torch.utils.misc import bf16_padded_rows, bf16_rounded

MAX_SERVING_MODEL = 464  # csrc/nss_prologue.cu kMaxDm


def _check(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
           conv_b: torch.Tensor, serving: bool = False) -> int:
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
    if serving and -(-dm // 16) * 16 > MAX_SERVING_MODEL:
        raise ValueError(f"mixer_prologue: d_model {dm} rounded up to 16 exceeds the serving "
                         f"body's {MAX_SERVING_MODEL}")
    return di


def mixer_prologue_plain(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                         conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z) in plain PyTorch. On a card, turn TF32 off first (cuBLAS and
    cuDNN) for a float32 reference."""
    di = conv_w.shape[0]
    xz = F.linear(h, w_in)
    x = F.conv2d(xz[..., :di].permute(0, 3, 1, 2), conv_w, conv_b, padding=1, groups=di)
    return F.silu(x).permute(0, 2, 3, 1).contiguous(), xz[..., di:].contiguous()


def prologue_serving_values(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                            conv_b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The serving body in plain PyTorch, stage by stage as
    ``tpuir/ops/nss_prologue.py:_forward(serving=True)`` computes it:
    ``w16`` = W_in's bf16 copy in rows padded to 8 (``bf16_padded_rows``),
    ``xpre`` and the z half = bf16(h) . bf16(W_in)^T summed in h's dtype
    (float32), x = bf16(silu(dw3x3(xpre) + b)), z = bf16(z half)."""
    di = conv_w.shape[0]
    xz = F.linear(bf16_rounded(h), bf16_rounded(w_in))
    xpre = xz[..., :di].contiguous()
    x = F.silu(F.conv2d(xpre.permute(0, 3, 1, 2), conv_w, conv_b, padding=1, groups=di))
    return {"w16": bf16_padded_rows(w_in), "xpre": xpre,
            "x": x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(),
            "z": xz[..., di:].to(torch.bfloat16).contiguous()}


def mixer_prologue_serving_plain(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                                 conv_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z), both bf16: the serving body in plain PyTorch. On a card, turn
    TF32 off first (cuDNN) for a float32 reference."""
    st = prologue_serving_values(h, w_in, conv_w, conv_b)
    return st["x"], st["z"]


def _launch(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
            di: int, serving: bool, stages: bool = False) -> Dict[str, torch.Tensor]:
    """One launch of a body on h's card: {x, z}; with ``stages`` (serving)
    also {w16, xpre}, the float32 x half written only then."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w_in, conv_w, conv_b)):
        raise RuntimeError("mixer_prologue: the CUDA kernel has no backward")
    B, H, W, dm = h.shape
    lib = _kernels.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    out = {}
    with torch.cuda.device(h.device):
        if serving:
            out["w16"] = torch.empty(2 * di, -(-dm // 8) * 8, device=h.device,
                                     dtype=torch.bfloat16)
            if stages:
                out["xpre"] = torch.empty(B, H, W, di, device=h.device, dtype=torch.float32)
            x = torch.empty(B, H, W, di, device=h.device, dtype=torch.bfloat16)
            z = torch.empty_like(x)
            err = lib.tpuir_mixer_prologue_bf16(
                h.data_ptr(), w_in.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                out["w16"].data_ptr(), out["xpre"].data_ptr() if stages else None,
                x.data_ptr(), z.data_ptr(), B, H, W, dm, di, stream)
        else:
            xpre = torch.empty(B, H, W, di, device=h.device, dtype=torch.float32)
            x = torch.empty_like(xpre)
            z = torch.empty_like(x)
            err = lib.tpuir_mixer_prologue_f32(
                h.data_ptr(), w_in.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                xpre.data_ptr(), x.data_ptr(), z.data_ptr(), B, H, W, dm, di, stream)
    _kernels.check(err, "mixer_prologue_serving" if serving else "mixer_prologue")
    out.update(x=x, z=z)
    return out


def mixer_prologue(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, serving: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. Forward only; h and the weights float32, x and z float32 or,
    with ``serving``, bf16."""
    di = _check(h, w_in, conv_w, conv_b, serving)
    if h.device.type == "cpu":
        plain = mixer_prologue_serving_plain if serving else mixer_prologue_plain
        return plain(h, w_in, conv_w, conv_b)
    out = _launch(h, w_in, conv_w, conv_b, di, serving)
    _kernels.LAUNCHES["mixer_prologue_serving" if serving else "mixer_prologue"] += 1
    return out["x"], out["z"]


def mixer_prologue_serving_stages(h: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
                                  conv_b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The serving kernel's outputs and its intermediates from one launch on
    h's card, for a check (``utils/serving_check.py``); counts no launch:
    ``w16`` (W_in's bf16 copy, rows padded to 8), ``xpre`` (the float32 x
    half of in_proj), ``x`` and ``z`` (bf16). On a CPU tensor, and only
    there, the same stages of the plain version."""
    di = _check(h, w_in, conv_w, conv_b, True)
    if h.device.type == "cpu":
        return prologue_serving_values(h, w_in, conv_w, conv_b)
    return _launch(h, w_in, conv_w, conv_b, di, True, stages=True)
