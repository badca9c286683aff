"""K5: MaIR's gather-free four-direction NSS selective scan, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_fused.py:nss_scan_fused``, which MaIR's
mixers take under ``TPUIR_NSS=fused`` (the port's ``nss="fused"``) on
levels whose H and W are multiples of ``scan_len``. The kernel is
``tpuir_torch/csrc/nss_fused.cu``, on the chunked scan it shares with K2
and K4 (``csrc/chunk_scan.cuh``); its source note gives the math, what
bounds it on the card and what the design does about that. It computes the
pixel each path position visits from the stripe arithmetic, with no id
table, and writes y straight into the JAX function's output layouts.

``nss_scan_fused`` is the wrapper: it raises ``ValueError`` where the JAX
function does (odd ``scan_len``; H or W not a multiple of it) and on
anything the kernel does not take. On a CUDA tensor it launches the kernel
on the current stream and counts the launch; on a CPU tensor, and only
there, it runs ``nss_scan_fused_plain``, the port of
``tpuir/ops/nss_fused.py:_reference`` (the id table of ``ops/scan_ids.py``,
einsum projections, the plain chunked scan, the inverse gather), which is
also what the kernel is held against on the card: the table against the
arithmetic.

x is (B, H, W, d) contiguous. Weights as the released checkpoints keep
them: ``x_proj_w`` (4, R + 2N, d), ``dt_w`` (4, d, R), ``D`` and
``delta_bias`` (4, d); ``A`` (4, d, N) is already -exp(A_logs). Returns
(y01 (B, 2, H, W, d), y23 (B, 2, W, H, d), pooled (B, 4, d)): y23[b, k, w,
h] is direction k + 2's output for pixel (h, w), and pooled the sums of y
over each path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_stripe import check_scan_weights
from tpuir_torch.ops.scan_ids import scan_index_tensors
from tpuir_torch.ops.selective_scan import selective_scan


def _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len: int) -> Tuple[int, int]:
    """Validate the inputs; return (N, R)."""
    if scan_len % 2 != 0:
        raise ValueError(f"nss_scan_fused: scan_len must be even; got {scan_len}")
    if x.dim() != 4 or x.shape[1] % scan_len or x.shape[2] % scan_len:
        raise ValueError(
            f"nss_scan_fused: H and W must be multiples of scan_len (directions 2/3 stripe "
            f"the transposed image); got {tuple(x.shape)}, scan_len {scan_len}")
    if not x.is_contiguous():
        raise ValueError("nss_scan_fused: x must be contiguous (B, H, W, d)")
    return check_scan_weights("nss_scan_fused", x, x_proj_w, dt_w, A, D, delta_bias)


def nss_scan_fused_plain(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                         A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                         scan_len: int = 4, shift: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y01, y23, pooled) in plain PyTorch. On a card, turn TF32 off first
    for a float32 reference."""
    B, H, W, d = x.shape
    L = H * W
    ids, inv = scan_index_tensors(H, W, scan_len, scan_len // 2 if shift else 0, x.device)
    N = A.shape[-1]
    R = x_proj_w.shape[1] - 2 * N
    xs = x.reshape(B, L, d)[:, ids]  # (B, 4, L, d), sequence order
    xdbl = torch.einsum("bkld,kcd->bklc", xs, x_proj_w)
    dts = torch.einsum("bklr,kdr->bkld", xdbl[..., :R], dt_w)
    y = selective_scan(xs, dts, A, xdbl[..., R:R + N], xdbl[..., R + N:], D, delta_bias,
                       delta_softplus=True, chunk=256)
    pooled = y.sum(2)
    yimg = torch.gather(y, 2, inv[None, :, :, None].expand(B, 4, L, d))  # pixel order
    y01 = yimg[:, :2].reshape(B, 2, H, W, d)
    y23 = yimg[:, 2:].reshape(B, 2, H, W, d).transpose(2, 3)
    return y01, y23, pooled


def nss_scan_fused(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                   scan_len: int = 4, shift: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y01, y23, pooled): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. ``shift`` takes the shifted NSS path (lead
    stripe of width scan_len / 2). Forward only, float32 only. The kernel's
    y01 and y23 are views of one (B, 4, H*W, d) buffer."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len)
    if x.device.type == "cpu":
        return nss_scan_fused_plain(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    params = (x, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("nss_scan_fused: the CUDA kernel has no backward")
    B, H, W, d = x.shape
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        y = torch.empty(B, 4, H * W, d, device=x.device, dtype=torch.float32)
        pooled = torch.empty(B, 4, d, device=x.device, dtype=torch.float32)
        # K2's scratch layout: x_dbl, chunk states and decay products, partials
        scratch = torch.empty(lib.tpuir_nss_scan_scratch_numel(B, H * W, d, N, R),
                              device=x.device, dtype=torch.float32)
        err = lib.tpuir_nss_scan_fused_f32(
            x.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(), A.data_ptr(), D.data_ptr(),
            delta_bias.data_ptr(), y.data_ptr(), pooled.data_ptr(), scratch.data_ptr(),
            B, H, W, d, N, R, scan_len, int(shift),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _kernels.check(err, "nss_scan_fused")
    _kernels.LAUNCHES["nss_scan_fused"] += 1
    return y[:, :2].view(B, 2, H, W, d), y[:, 2:].view(B, 2, W, H, d), pooled
