"""K3: MaIR's selective scan with fused projections, hand-written for Hopper.

The counterpart of ``tpuir/ops/scan_pallas.py:selective_scan_fused_proj``:
the x_proj and dt_proj projections, softplus, the selective scan and D*x on
sequences already gathered along the four NSS paths. MaIR's mixer takes it
on a pyramid level whose H or W is not a multiple of ``scan_len``, where K2
(``ops/nss_stripe.py``) does not apply, and on every level under
``nss="0"``. The kernel is ``tpuir_torch/csrc/scan_fused_proj.cu``, in its
two bodies: float32 parity (``tpuir_scan_fused_proj_f32``) and serving
(``tpuir_scan_fused_proj_bf16``, the TPU kernel with ``serving=True``: bf16
xs, x_proj and dt_proj of bf16-rounded operands summed in float32, B, C, the
scan and y in float32): x_dbl on the float32 SIMT GEMM it shares with K2 and
K5, then one pass over each sequence with a channel's states across a
warp's lanes; its source note gives what bounds it on the card and what the
design does about that.

``selective_scan_fused_proj`` is the wrapper: it checks its inputs and
raises on anything the kernel does not take. On a CUDA tensor it launches
the kernel on the current stream and counts the launch, under
``selective_scan_fused_proj`` or, for the serving body,
``selective_scan_fused_proj_serving``; on a CPU tensor, and only there, it
runs ``selective_scan_fused_proj_plain``, the port of
``tpuir/ops/scan_pallas.py:_reference_composition`` (einsum projections,
softplus, the plain chunked scan, D*x), or
``selective_scan_fused_proj_serving_plain``, which are also what the kernel
is held against on the card. ``selective_scan_fused_proj_serving_stages``
returns the serving body's x_dbl, unpacked from its scratch, beside y, for
the stage-by-stage check of ``utils/serving_check.py``. Every parity call goes through
the Function of ``ops/kernel_grad.py`` (the kernel forward, the plain
version's backward, as tpuir's ``custom_vjp``); the serving body raises
under autograd on the card.

xs is (B, 4, L, d) contiguous in sequence order, float32 or, serving, bf16
with d even; y comes back float32 in the same shape; there is no pooled
output. Weights as the released checkpoints keep them, float32:
``x_proj_w`` (4, R + 2N, d), ``dt_w`` (4, d, R), ``D`` and ``delta_bias``
(4, d); ``A`` (4, d, N) is already -exp(A_logs). The serving kernel rounds
W_xp and W_dt where it loads them, so no bf16 weight copy is made.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpuir_torch.ops import _kernels, kernel_grad
from tpuir_torch.ops.nss_stripe import check_scan_weights, seq_scan_from_xdbl, state_ceiling
from tpuir_torch.ops.selective_scan import selective_scan
from tpuir_torch.utils.misc import bf16_rounded


def _check(xs, x_proj_w, dt_w, A, D, delta_bias, serving: bool = False) -> Tuple[int, int]:
    """Validate the inputs; return (N, R)."""
    if xs.dim() != 4 or xs.shape[1] != 4 or not xs.is_contiguous():
        raise ValueError(
            f"selective_scan_fused_proj: xs must be contiguous (B, 4, L, d), got {tuple(xs.shape)}")
    if serving and xs.shape[-1] % 2:
        raise ValueError("selective_scan_fused_proj: the serving body stages xs two channels "
                         f"a copy and needs an even d, got {xs.shape[-1]}")
    return check_scan_weights("selective_scan_fused_proj", xs, x_proj_w, dt_w, A, D, delta_bias,
                              torch.bfloat16 if serving else torch.float32)


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
                          delta_softplus=True, chunk=256, dtype=xs.dtype)


def seq_scan_serving_values(xs: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                            A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
    """The serving body in plain float32 PyTorch, stage by stage as
    ``tpuir/ops/scan_pallas.py:_fused_forward(serving=True)`` computes it:
    ``x_dbl`` = bf16(xs) . bf16(W_xp)^T summed in float32 (B, 4, L, C), then
    ``seq_scan_from_xdbl``: ``y`` float32."""
    xw = xs.float()
    xdbl = torch.einsum("bkld,kcd->bklc", xw, bf16_rounded(x_proj_w))
    return {"x_dbl": xdbl, "y": seq_scan_from_xdbl(xw, xdbl, dt_w, A, D, delta_bias)}


def selective_scan_fused_proj_serving_plain(xs: torch.Tensor, x_proj_w: torch.Tensor,
                                            dt_w: torch.Tensor, A: torch.Tensor,
                                            D: torch.Tensor, delta_bias: torch.Tensor
                                            ) -> torch.Tensor:
    """y (B, 4, L, d) float32 from a bf16 xs: the serving body in plain
    PyTorch. On a card, turn TF32 off first for a float32 reference."""
    return seq_scan_serving_values(xs, x_proj_w, dt_w, A, D, delta_bias)["y"]


def _packed_row(N: int, R: int) -> Tuple[int, int, int]:
    """(R4, MAXN, CS) of the kernel's packed x_dbl rows
    (``csrc/scan_fused_proj.cu:seq_row_floats``): [dt_r (R, zeros to R4) |
    B (MAXN) | C (MAXN)], CS floats a row, a multiple of 4 whose quarter is
    odd."""
    r4 = (R + 3) & ~3
    maxn = state_ceiling(N)
    cs = r4 + 2 * maxn
    return r4, maxn, cs if (cs // 4) % 2 else cs + 4


def _launch(xs, x_proj_w, dt_w, A, D, delta_bias, N, R, serving
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of a body on xs's card: (y, the kernel's scratch)."""
    params = (xs, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("selective_scan_fused_proj: the CUDA kernel has no backward")
    B, _, L, d = xs.shape
    lib = _kernels.library()
    fn = lib.tpuir_scan_fused_proj_bf16 if serving else lib.tpuir_scan_fused_proj_f32
    with torch.cuda.device(xs.device):
        y = torch.empty(xs.shape, device=xs.device, dtype=torch.float32)
        scratch = torch.empty(lib.tpuir_scan_fused_proj_scratch_numel(B, L, d, N, R),
                              device=xs.device, dtype=torch.float32)
        err = fn(xs.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(), A.data_ptr(), D.data_ptr(),
                 delta_bias.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, L, d, N, R,
                 torch.cuda.current_stream(xs.device).cuda_stream)
    _kernels.check(err, "selective_scan_fused_proj_serving" if serving
                   else "selective_scan_fused_proj")
    return y, scratch


def selective_scan_fused_proj(xs: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                              A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                              serving: bool = False) -> torch.Tensor:
    """y: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. xs float32 or, with ``serving``, bf16; y float32. The parity
    body is differentiable (``ops/kernel_grad.py``: the plain version's
    gradient); the serving body is forward only."""
    N, R = _check(xs, x_proj_w, dt_w, A, D, delta_bias, serving)
    params = (xs, x_proj_w, dt_w, A, D, delta_bias)
    if not serving:
        return _parity_grad(params)
    if xs.device.type == "cpu":
        return selective_scan_fused_proj_serving_plain(*params)
    y, _ = _launch(*params, N, R, True)
    _kernels.LAUNCHES["selective_scan_fused_proj_serving"] += 1
    return y


def _parity_kernel(xs, x_proj_w, dt_w, A, D, delta_bias) -> torch.Tensor:
    """y from one counted launch of the parity body on xs's card."""
    N = A.shape[-1]
    y, _ = _launch(xs, x_proj_w, dt_w, A, D, delta_bias, N, x_proj_w.shape[1] - 2 * N, False)
    _kernels.LAUNCHES["selective_scan_fused_proj"] += 1
    return y


# tpuir/ops/scan_pallas.py:_fused_vjp: the kernel forward, the plain backward
_parity_grad = kernel_grad.differentiable(_parity_kernel, selective_scan_fused_proj_plain)


def selective_scan_fused_proj_serving_stages(xs: torch.Tensor, x_proj_w: torch.Tensor,
                                             dt_w: torch.Tensor, A: torch.Tensor,
                                             D: torch.Tensor, delta_bias: torch.Tensor
                                             ) -> Dict[str, torch.Tensor]:
    """The serving kernel's output and its x_dbl from one launch on xs's
    card, for a check (``utils/serving_check.py``); counts no launch:
    ``x_dbl`` (B, 4, L, R + 2N) float32, unpacked from the kernel's scratch,
    and ``y``. On a CPU tensor, and only there, the same stages of the plain
    version."""
    N, R = _check(xs, x_proj_w, dt_w, A, D, delta_bias, True)
    if xs.device.type == "cpu":
        return seq_scan_serving_values(xs, x_proj_w, dt_w, A, D, delta_bias)
    y, scratch = _launch(xs, x_proj_w, dt_w, A, D, delta_bias, N, R, True)
    B, _, L, _ = xs.shape
    r4, maxn, cs = _packed_row(N, R)
    rows = scratch[:B * 4 * L * cs].view(B, 4, L, cs)
    xdbl = torch.cat([rows[..., :R], rows[..., r4:r4 + N], rows[..., r4 + maxn:r4 + maxn + N]],
                     -1)
    return {"x_dbl": xdbl, "y": y}
