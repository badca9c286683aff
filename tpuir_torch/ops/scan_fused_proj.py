"""K3: MaIR's selective scan with fused projections, hand-written for Hopper.

The counterpart of ``tpuir/ops/scan_pallas.py:selective_scan_fused_proj``:
the x_proj and dt_proj projections, softplus, the selective scan and D*x on
sequences already gathered along the four NSS paths. MaIR's mixer takes it
on a pyramid level whose H or W is not a multiple of ``scan_len``, where K2
(``ops/nss_stripe.py``) does not apply. The kernel is
``tpuir_torch/csrc/scan_fused_proj.cu``: x_dbl on the float32 SIMT GEMM it
shares with K2 and K5, then one pass over each sequence with a channel's
states across a warp's lanes; its source note gives what bounds it on the
card and what the design does about that.

``selective_scan_fused_proj`` is the wrapper: it checks its inputs and
raises on anything the kernel does not take. On a CUDA tensor it launches
the kernel on the current stream and counts the launch; on a CPU tensor,
and only there, it runs ``selective_scan_fused_proj_plain``, the port of
``tpuir/ops/scan_pallas.py:_reference_composition`` (einsum projections,
softplus, the plain chunked scan, D*x), which is also what the kernel is
held against on the card.

xs is (B, 4, L, d) contiguous float32 in sequence order, and y comes back
in the same shape; there is no pooled output. Weights as the released
checkpoints keep them: ``x_proj_w`` (4, R + 2N, d), ``dt_w`` (4, d, R),
``D`` and ``delta_bias`` (4, d); ``A`` (4, d, N) is already -exp(A_logs).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_stripe import check_scan_weights
from tpuir_torch.ops.selective_scan import selective_scan


def _check(xs, x_proj_w, dt_w, A, D, delta_bias) -> Tuple[int, int]:
    """Validate the inputs; return (N, R)."""
    if xs.dim() != 4 or xs.shape[1] != 4 or not xs.is_contiguous():
        raise ValueError(
            f"selective_scan_fused_proj: xs must be contiguous (B, 4, L, d), got {tuple(xs.shape)}")
    return check_scan_weights("selective_scan_fused_proj", xs, x_proj_w, dt_w, A, D, delta_bias)


def selective_scan_fused_proj_plain(xs: torch.Tensor, x_proj_w: torch.Tensor,
                                    dt_w: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                                    delta_bias: torch.Tensor) -> torch.Tensor:
    """y (B, 4, L, d) in plain PyTorch. On a card, turn TF32 off first for a
    float32 reference."""
    N = A.shape[-1]
    R = x_proj_w.shape[1] - 2 * N
    xdbl = torch.einsum("bkld,kcd->bklc", xs, x_proj_w)
    dts = torch.einsum("bklr,kdr->bkld", xdbl[..., :R], dt_w)
    return selective_scan(xs, dts, A, xdbl[..., R:R + N], xdbl[..., R + N:], D, delta_bias,
                          delta_softplus=True, chunk=256)


def selective_scan_fused_proj(xs: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                              A: torch.Tensor, D: torch.Tensor,
                              delta_bias: torch.Tensor) -> torch.Tensor:
    """y: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. Forward only, float32 only."""
    N, R = _check(xs, x_proj_w, dt_w, A, D, delta_bias)
    if xs.device.type == "cpu":
        return selective_scan_fused_proj_plain(xs, x_proj_w, dt_w, A, D, delta_bias)
    params = (xs, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("selective_scan_fused_proj: the CUDA kernel has no backward")
    B, _, L, d = xs.shape
    lib = _kernels.library()
    with torch.cuda.device(xs.device):
        y = torch.empty_like(xs)
        scratch = torch.empty(lib.tpuir_scan_fused_proj_scratch_numel(B, L, d, N, R),
                              device=xs.device, dtype=torch.float32)
        err = lib.tpuir_scan_fused_proj_f32(
            xs.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(), A.data_ptr(), D.data_ptr(),
            delta_bias.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, L, d, N, R,
            torch.cuda.current_stream(xs.device).cuda_stream,
        )
    _kernels.check(err, "selective_scan_fused_proj")
    _kernels.LAUNCHES["selective_scan_fused_proj"] += 1
    return y
