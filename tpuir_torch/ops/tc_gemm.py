"""The tensor-core GEMM core of K1, K6 and K7, alone, for measurement.

``gemm_f32x3`` and ``gemm_bf16`` are the wrappers of
``tpuir_torch/csrc/tc_gemm.cu``: the core of ``csrc/tc_gemm.cuh``
(``mma.sync``, a ``cp.async`` ring) in its two precisions, 3xTF32 (float32
parity) and bf16 products with float32 sums (K6's and K7's serving bodies), with its
LayerNorm prologue and its row store. K1 (``csrc/fused_block.cu``), K6
(``csrc/nss_prologue.cu``) and K7 (``csrc/nss_epilogue.cu``) call the core
from C; the port's models never call these wrappers. They exist so that the
core's accuracy and rate can be held against float64 and ``torch.matmul``
at the shapes of those kernels' products (``chip_smoke.py`` phases 2, 4, 6
and 12, ``tests/test_torch_gemm_core.py``,
``tests/test_torch_fused_block_serving.py``).

On a CUDA tensor each launches the kernel on the current stream and counts
the launch under ``tc_gemm`` or ``tc_gemm_bf16``; on a CPU tensor, and only
there, it runs its plain version, ``gemm_plain`` (``gemm_bf16_plain``: the
same on bf16-rounded operands), the same function in plain PyTorch:

    out[z, m, n] = resid[z, m, n] + sum_k A'[z, m, k] * w[z, n, k]

``a`` is (M, K) or (batch, M, K) float32 with unit stride along K (its rows
may be strided, as a column slice of a wider tensor); ``w`` is (N, K), or
(batch, N, K) for one weight an image, contiguous; ``resid`` is None or
contiguous in the output's shape. ``ln`` is None or (weight (K,), bias (K,)
or None): A' = (A - mu) * rstd * weight + bias with a bias, and
A * rstd * weight without (Restormer's WithBias and BiasFree LayerNorms,
biased variance, eps 1e-5). The core reads each row's (mu, rstd) from a
table, which the wrapper computes with torch before the launch. In bf16
mode A' (after the LayerNorm) and w are rounded to bf16, to nearest even,
and their products summed in float32; a product of two bf16 values is exact
in float32, so the plain version is ``gemm_plain`` on the rounded operands.

``gemm_bf16_operands`` is the wrapper of the core's bf16-operand kernel (K1's
serving body's apply, projection and project_out): ``a`` and ``w`` bf16 as
stored (K a multiple of 8), no LayerNorm, float32 sums and a float32 output;
counted under ``tc_gemm_bf16_operands``; its plain version is ``gemm_plain``
on the operands widened.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpuir_torch.ops import _kernels

LnArgs = Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _check(a: torch.Tensor, w: torch.Tensor, resid: Optional[torch.Tensor],
           ln: LnArgs, name: str = "gemm_f32x3") -> Tuple[int, int, int, int]:
    """Validate the inputs; return (batch, M, N, K)."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got {a.dtype}")
    if a.dim() not in (2, 3) or a.stride(-1) != 1:
        raise ValueError(f"{name}: a must be (M, K) or (batch, M, K) with unit stride "
                         f"along K, got shape {tuple(a.shape)} strides {a.stride()}")
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    if w.dim() not in (2, 3) or w.shape[-1] != K or (w.dim() == 3 and (
            a.dim() != 3 or w.shape[0] != batch)):
        raise ValueError(f"{name}: w has shape {tuple(w.shape)}, want (N, {K}) or "
                         f"({batch}, N, {K}) for a of shape {tuple(a.shape)}")
    N = w.shape[-2]
    tensors = {"w": w}
    if resid is not None:
        tensors["resid"] = resid
        if tuple(resid.shape) != tuple(a.shape[:-1]) + (N,):
            raise ValueError(f"{name}: resid has shape {tuple(resid.shape)}, want "
                             f"{tuple(a.shape[:-1]) + (N,)}")
    if ln is not None:
        for what, t in zip(("ln weight", "ln bias"), ln):
            if t is None:
                continue
            tensors[what] = t
            if tuple(t.shape) != (K,):
                raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, want ({K},)")
    for what, t in tensors.items():
        if t.dtype != torch.float32 or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 on {a.device}")
    if min(M, N, K) <= 0:
        raise ValueError(f"{name}: empty product M={M} N={N} K={K}")
    return batch, M, N, K


def _ln_stats(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, rstd) of each row over the last axis: biased variance, eps 1e-5."""
    mu = a.mean(-1, keepdim=True)
    return mu, torch.rsqrt(((a - mu) ** 2).mean(-1, keepdim=True) + 1e-5)


def _layer_norm(a: torch.Tensor, ln: Tuple[torch.Tensor, Optional[torch.Tensor]]
                ) -> torch.Tensor:
    weight, bias = ln
    mu, rstd = _ln_stats(a)
    a = (a - mu if bias is not None else a) * rstd * weight
    return a + bias if bias is not None else a


def gemm_plain(a: torch.Tensor, w: torch.Tensor, resid: Optional[torch.Tensor] = None,
               ln: LnArgs = None) -> torch.Tensor:
    """The core's function in plain PyTorch. On a card, turn TF32 off first
    for a float32 reference."""
    if ln is not None:
        a = _layer_norm(a, ln)
    out = a @ w.transpose(-1, -2)
    return resid + out if resid is not None else out


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def gemm_bf16_plain(a: torch.Tensor, w: torch.Tensor, resid: Optional[torch.Tensor] = None,
                    ln: LnArgs = None) -> torch.Tensor:
    """The core's bf16 mode in plain PyTorch: ``gemm_plain`` on A' and w
    rounded to bf16. On a card, turn TF32 off first for a float32 reference."""
    if ln is not None:
        a = _layer_norm(a, ln)
    return gemm_plain(_round_bf16(a), _round_bf16(w), resid)


def gemm_f32x3(a: torch.Tensor, w: torch.Tensor, resid: Optional[torch.Tensor] = None,
               ln: LnArgs = None) -> torch.Tensor:
    """The core on a CUDA tensor, ``gemm_plain`` on a CPU tensor. Forward only."""
    _check(a, w, resid, ln)
    if a.device.type == "cpu":
        return gemm_plain(a, w, resid, ln)
    return _launch("f32", a, w, resid, ln)


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, resid: Optional[torch.Tensor] = None,
              ln: LnArgs = None) -> torch.Tensor:
    """The core's bf16 mode on a CUDA tensor, ``gemm_bf16_plain`` on a CPU
    tensor. Forward only; operands and output float32."""
    _check(a, w, resid, ln, "gemm_bf16")
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, w, resid, ln)
    return _launch("bf16", a, w, resid, ln)


def _launch(mode: str, a: torch.Tensor, w: torch.Tensor, resid: Optional[torch.Tensor],
            ln: LnArgs) -> torch.Tensor:
    """Launch the core in ``mode`` ("f32": 3xTF32, "bf16") on checked CUDA inputs."""
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N = w.shape[-2]
    lib = _kernels.library()
    with torch.cuda.device(a.device):
        out = torch.empty(tuple(a.shape[:-1]) + (N,), device=a.device, dtype=torch.float32)
        stats = ln_w = ln_b = None
        if ln is not None:
            mu, rstd = _ln_stats(a)
            stats = torch.cat([mu, rstd], -1).contiguous()
            ln_w = ln[0].data_ptr()
            ln_b = ln[1].data_ptr() if ln[1] is not None else None
        err = getattr(lib, f"tpuir_tc_gemm_{mode}")(
            a.data_ptr(), a.stride(0) if a.dim() == 3 else 0, a.stride(-2),
            w.data_ptr(), w.stride(0) if w.dim() == 3 else 0,
            resid.data_ptr() if resid is not None else None, out.data_ptr(), N,
            stats.data_ptr() if stats is not None else None, ln_w, ln_b,
            int(ln is not None and ln[1] is not None), batch, M, N, K,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _kernels.check(err, "gemm_f32x3" if mode == "f32" else "gemm_bf16")
    _kernels.LAUNCHES["tc_gemm" if mode == "f32" else "tc_gemm_bf16"] += 1
    return out


def gemm_bf16_operands(a: torch.Tensor, w: torch.Tensor,
                       resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The core's bf16-operand kernel on a CUDA tensor, ``gemm_plain`` of the
    widened operands on a CPU tensor. Forward only; a and w bf16, resid and
    the output float32."""
    name = "gemm_bf16_operands"
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: a and w must be bfloat16, got {a.dtype}, {w.dtype}")
    batch, M, N, K = _check(a.float(), w.float(), resid, None, name)
    if a.device.type == "cpu":
        return gemm_plain(a.float(), w.float(), resid)
    if (K % 8 or a.stride(-1) != 1 or a.stride(-2) % 8 or (a.dim() == 3 and a.stride(0) % 8)
            or not w.is_contiguous()):
        raise ValueError(f"{name}: K and a's row strides must be multiples of 8, a's unit "
                         f"along K, w contiguous")
    with torch.cuda.device(a.device):
        out = torch.empty(tuple(a.shape[:-1]) + (N,), device=a.device, dtype=torch.float32)
        err = _kernels.library().tpuir_tc_gemm_bf16_operands(
            a.data_ptr(), a.stride(0) if a.dim() == 3 else 0, a.stride(-2),
            w.data_ptr(), w.stride(0) if w.dim() == 3 else 0,
            resid.data_ptr() if resid is not None else None, out.data_ptr(), N, batch, M, N, K,
            torch.cuda.current_stream(a.device).cuda_stream)
    _kernels.check(err, name)
    _kernels.LAUNCHES["tc_gemm_bf16_operands"] += 1
    return out
