"""K7: the MaIR mixer's epilogue, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_epilogue.py:mixer_epilogue``: the gated
four-direction sum, out_norm (LayerNorm over d_inner), times SiLU(z), then
out_proj. The kernel is ``tpuir_torch/csrc/nss_epilogue.cu``: the gated
rows, then out_proj on the tensor-core GEMM core, in its two bodies:
float32 parity (``tpuir_mixer_epilogue_f32``, 3xTF32) and serving
(``tpuir_mixer_epilogue_bf16``, the TPU kernel with ``serving=True``: bf16
y and z, the one-pass LayerNorm variance, the gated rows stored rounded to
bf16, out_proj of those and a bf16 copy of W_out on the core's bf16-operand
kernel, summed in float32, a float32 output); its source note gives what
bounds it on the card and what the design does about that. It takes K2's
output in image layout, so there is no half-block select. The wrapper
allocates the kernel's scratch: the gated rows and a copy of ``w_out``,
both ``padded_inner(d_inner, serving)`` values wide.

``mixer_epilogue`` is the wrapper: it checks its inputs and raises on
anything the kernel does not take. On a CUDA tensor it launches the kernel
on the current stream and counts the launch, under ``mixer_epilogue`` or,
for the serving body, ``mixer_epilogue_serving``; on a CPU tensor, and only
there, it runs ``mixer_epilogue_plain`` or ``mixer_epilogue_serving_plain``,
the same math in plain PyTorch, which is also what the kernel is held
against on the card. ``mixer_epilogue_serving_stages`` returns the serving
body's W_out copy and gated rows beside its output, for the stage-by-stage
check of ``utils/serving_check.py``.

Shapes: y (B, 4, H, W, d_inner) and z (B, H, W, d_inner) contiguous,
float32 or, serving, bf16; gates (B, 4, d_inner), ln_w and ln_b
(d_inner,), ``w_out`` (d_model, d_inner) (an ``nn.Linear`` weight), all
float32. Returns (B, H, W, d_model) float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels
from tpuir_torch.utils.misc import bf16_padded_rows, bf16_rounded

MAX_INNER = 1024  # 32 channels a lane at most in the per-pixel warp


def padded_inner(di: int, serving: bool = False) -> int:
    """The row width of the gated rows and of the padded out_proj weight:
    d_inner rounded up to a multiple of 4 floats or, serving, of 8 bf16
    values, for 16-byte copies."""
    q = 8 if serving else 4
    return -(-di // q) * q


def _check(y, gates, z, ln_w, ln_b, w_out, serving: bool) -> None:
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mixer_epilogue: unsupported device {y.device}")
    io = torch.bfloat16 if serving else torch.float32
    if y.dtype != io or z.dtype != io:
        mode = "serving" if serving else "parity"
        raise TypeError(f"mixer_epilogue: y and z must be {io} in {mode} mode, "
                        f"got {y.dtype}, {z.dtype}")
    if y.dim() != 5 or y.shape[1] != 4:
        raise ValueError(f"mixer_epilogue: y must be (B, 4, H, W, d), got {tuple(y.shape)}")
    B, _, H, W, di = y.shape
    if di > MAX_INNER:
        raise ValueError(f"mixer_epilogue: d_inner {di} > {MAX_INNER}")
    dm = w_out.shape[0]
    want = {"y": (y, (B, 4, H, W, di)), "gates": (gates, (B, 4, di)), "z": (z, (B, H, W, di)),
            "ln_w": (ln_w, (di,)), "ln_b": (ln_b, (di,)), "w_out": (w_out, (dm, di))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mixer_epilogue: {name} has shape {tuple(t.shape)}, want {shape}")
        dtype = io if name in ("y", "z") else torch.float32
        if t.dtype != dtype or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"mixer_epilogue: {name} must be contiguous {dtype} on {y.device}")


def mixer_epilogue_plain(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor,
                         ln_w: torch.Tensor, ln_b: torch.Tensor,
                         w_out: torch.Tensor) -> torch.Tensor:
    """out_proj(out_norm(sum_k gates_k * y_k) * silu(z)) in plain PyTorch.
    On a card, turn TF32 off first for a float32 reference."""
    g = gates[:, :, None, None, :]
    s = y[:, 0] * g[:, 0] + y[:, 1] * g[:, 1] + y[:, 2] * g[:, 2] + y[:, 3] * g[:, 3]
    mu = s.mean(-1, keepdim=True)
    var = ((s - mu) ** 2).mean(-1, keepdim=True)
    sn = (s - mu) * torch.rsqrt(var + 1e-5) * ln_w + ln_b
    return F.linear(sn * F.silu(z), w_out)


def gated_rows_serving(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor,
                       ln_w: torch.Tensor, ln_b: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The serving body's gated rows in ``dtype`` (float32; float64 for a
    reference), as ``tpuir/ops/nss_epilogue.py:_forward(serving=True)``
    computes them: s = y0 g0 + y1 g1 + y2 g2 + y3 g3 of the widened y, the
    one-pass variance max(E[s^2] - mu^2, 0), (s - mu) rsqrt(var + 1e-5)
    ln_w + ln_b, times z sigmoid(z) of the widened z. (B, H, W, d_inner)."""
    yw, g = y.to(dtype), gates.to(dtype)[:, :, None, None, :]
    s = yw[:, 0] * g[:, 0] + yw[:, 1] * g[:, 1] + yw[:, 2] * g[:, 2] + yw[:, 3] * g[:, 3]
    mu = s.mean(-1, keepdim=True)
    var = ((s * s).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    sn = (s - mu) * torch.rsqrt(var + 1e-5) * ln_w.to(dtype) + ln_b.to(dtype)
    return sn * F.silu(z.to(dtype))


def epilogue_serving_values(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor,
                            ln_w: torch.Tensor, ln_b: torch.Tensor,
                            w_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The serving body in plain float32 PyTorch, stage by stage: ``w16``
    (W_out's bf16 copy, ``bf16_padded_rows``), ``gated`` (B, H, W,
    padded_inner(d_inner, serving=True)) rounded to bf16 and zero-padded as
    the kernel's scratch, and ``out`` = bf16(gated) . bf16(W_out)^T summed
    in float32."""
    di = y.shape[-1]
    gated = gated_rows_serving(y, gates, z, ln_w, ln_b).to(torch.bfloat16)
    out = F.linear(gated.float(), bf16_rounded(w_out))
    return {"w16": bf16_padded_rows(w_out),
            "gated": F.pad(gated, (0, padded_inner(di, serving=True) - di)), "out": out}


def mixer_epilogue_serving_plain(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor,
                                 ln_w: torch.Tensor, ln_b: torch.Tensor,
                                 w_out: torch.Tensor) -> torch.Tensor:
    """The serving body in plain PyTorch: y and z bf16, a float32 output. On
    a card, turn TF32 off first for a float32 reference."""
    return epilogue_serving_values(y, gates, z, ln_w, ln_b, w_out)["out"]


def _launch(y, gates, z, ln_w, ln_b, w_out, serving: bool) -> Dict[str, torch.Tensor]:
    """One launch of a body on y's card: {w16 (serving), gated, out}."""
    params = (y, gates, z, ln_w, ln_b, w_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("mixer_epilogue: the CUDA kernel has no backward")
    B, _, H, W, di = y.shape
    dm = w_out.shape[0]
    dp = padded_inner(di, serving)
    lib = _kernels.library()
    fn = lib.tpuir_mixer_epilogue_bf16 if serving else lib.tpuir_mixer_epilogue_f32
    rows = torch.bfloat16 if serving else torch.float32
    with torch.cuda.device(y.device):
        gated = torch.empty(B, H, W, dp, device=y.device, dtype=rows)
        w_pad = torch.empty(dm, dp, device=y.device, dtype=rows)
        out = torch.empty(B, H, W, dm, device=y.device, dtype=torch.float32)
        err = fn(y.data_ptr(), gates.data_ptr(), z.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                 w_out.data_ptr(), gated.data_ptr(), w_pad.data_ptr(), out.data_ptr(), B, H * W,
                 di, dm, torch.cuda.current_stream(y.device).cuda_stream)
    _kernels.check(err, "mixer_epilogue_serving" if serving else "mixer_epilogue")
    return {"w16": w_pad, "gated": gated, "out": out} if serving else {"gated": gated, "out": out}


def mixer_epilogue(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor, ln_w: torch.Tensor,
                   ln_b: torch.Tensor, w_out: torch.Tensor, serving: bool = False) -> torch.Tensor:
    """The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    Forward only; y and z float32 or, with ``serving``, bf16; a float32
    output."""
    _check(y, gates, z, ln_w, ln_b, w_out, serving)
    if y.device.type == "cpu":
        plain = mixer_epilogue_serving_plain if serving else mixer_epilogue_plain
        return plain(y, gates, z, ln_w, ln_b, w_out)
    out = _launch(y, gates, z, ln_w, ln_b, w_out, serving)["out"]
    _kernels.LAUNCHES["mixer_epilogue_serving" if serving else "mixer_epilogue"] += 1
    return out


def mixer_epilogue_serving_stages(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor,
                                  ln_w: torch.Tensor, ln_b: torch.Tensor,
                                  w_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The serving kernel's output and its intermediates from one launch on
    y's card, for a check (``utils/serving_check.py``); counts no launch:
    ``w16`` (W_out's bf16 copy, rows padded to 8), ``gated`` (B, H, W,
    padded_inner(d_inner, serving=True)) bf16 and ``out``. On a CPU tensor,
    and only there, the same stages of the plain version."""
    _check(y, gates, z, ln_w, ln_b, w_out, True)
    if y.device.type == "cpu":
        return epilogue_serving_values(y, gates, z, ln_w, ln_b, w_out)
    return _launch(y, gates, z, ln_w, ln_b, w_out, True)
