"""K7: the MaIR mixer's epilogue, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_epilogue.py:mixer_epilogue``: the gated
four-direction sum, out_norm (LayerNorm over d_inner), times SiLU(z), then
out_proj. The kernel is ``tpuir_torch/csrc/nss_epilogue.cu``: the gated
rows, then out_proj on the tensor-core GEMM core in 3xTF32; its source note
gives what bounds it on the card and what the design does about that. It
takes K2's output in image layout, so there is no half-block select. The
wrapper allocates the kernel's scratch: the gated rows and a copy of
``w_out``, both ``padded_inner(d_inner)`` floats wide.

``mixer_epilogue`` is the wrapper: it checks its inputs and raises on
anything the kernel does not take. On a CUDA tensor it launches the kernel
on the current stream and counts the launch; on a CPU tensor, and only
there, it runs ``mixer_epilogue_plain``, the same math in plain PyTorch,
which is also what the kernel is held against on the card.

Shapes: y (B, 4, H, W, d_inner) and z (B, H, W, d_inner) contiguous, gates
(B, 4, d_inner), ln_w and ln_b (d_inner,), ``w_out`` (d_model, d_inner) (an
``nn.Linear`` weight). Returns (B, H, W, d_model).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels

MAX_INNER = 1024  # 32 channels a lane at most in the per-pixel warp


def padded_inner(di: int) -> int:
    """The row width of the gated rows and of the padded out_proj weight:
    d_inner rounded up to a multiple of 4 floats, for 16-byte copies."""
    return -(-di // 4) * 4


def _check(y, gates, z, ln_w, ln_b, w_out) -> None:
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mixer_epilogue: unsupported device {y.device}")
    if y.dtype != torch.float32:
        raise TypeError(f"mixer_epilogue: float32 only, got {y.dtype}")
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
        if t.dtype != torch.float32 or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"mixer_epilogue: {name} must be contiguous float32 on {y.device}")


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


def mixer_epilogue(y: torch.Tensor, gates: torch.Tensor, z: torch.Tensor, ln_w: torch.Tensor,
                   ln_b: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    Forward only, float32 only."""
    _check(y, gates, z, ln_w, ln_b, w_out)
    if y.device.type == "cpu":
        return mixer_epilogue_plain(y, gates, z, ln_w, ln_b, w_out)
    params = (y, gates, z, ln_w, ln_b, w_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("mixer_epilogue: the CUDA kernel has no backward")
    B, _, H, W, di = y.shape
    dm = w_out.shape[0]
    dp = padded_inner(di)
    lib = _kernels.library()
    with torch.cuda.device(y.device):
        gated = torch.empty(B, H, W, dp, device=y.device, dtype=torch.float32)
        w_pad = torch.empty(dm, dp, device=y.device, dtype=torch.float32)
        out = torch.empty(B, H, W, dm, device=y.device, dtype=torch.float32)
        err = lib.tpuir_mixer_epilogue_f32(
            y.data_ptr(), gates.data_ptr(), z.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
            w_out.data_ptr(), gated.data_ptr(), w_pad.data_ptr(), out.data_ptr(), B, H * W, di,
            dm, torch.cuda.current_stream(y.device).cuda_stream,
        )
    _kernels.check(err, "mixer_epilogue")
    _kernels.LAUNCHES["mixer_epilogue"] += 1
    return out
