"""K2: MaIR's four-direction NSS selective scan, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_stripe.py`` (``nss_scan_stripe_pre`` and
``nss_scan_stripe``, square and rectangular tiles). The kernel is
``tpuir_torch/csrc/nss_scan.cu``; its source note gives the math, what
bounds it on the card and what the design does about that. It reads x
through the NSS id table of ``ops/scan_ids.py`` and writes y to each path
position's image pixel, so it returns y directly in image layout: there are
no half-block buffers to recombine.

``nss_scan`` is the wrapper: it checks its inputs and raises on anything
the kernel does not take. On a CUDA tensor it launches the kernel on the
current stream and counts the launch; on a CPU tensor, and only there, it
runs ``nss_scan_plain``, the port of ``tpuir/ops/nss_stripe.py:_reference``
(gather by scan ids, the two projections, softplus, the plain chunked scan,
D*x, pooled sums, inverse gather), which is also what the kernel is held
against on the card.

x is (B, H, W, d) contiguous. Weights as the released checkpoints keep
them: ``x_proj_w`` (4, R + 2N, d), ``dt_w`` (4, d, R), ``D`` and
``delta_bias`` (4, d); ``A`` (4, d, N) is already -exp(A_logs).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.ops.scan_ids import mair_scan_ids, scan_ids_tensor
from tpuir_torch.ops.selective_scan import selective_scan

MAX_STATE = 32  # the kernel keeps a channel's states in registers (8, 16 or 32 of them)
MAX_RANK = 64   # dt rank R: W_dt is staged in shared memory


def check_scan_weights(fn: str, x, x_proj_w, dt_w, A, D, delta_bias) -> Tuple[int, int]:
    """Validate x's device and dtype and the four directions' scan weights
    against x's last (channel) dimension, for the wrapper named ``fn`` (K2,
    K3, K5); return (N, R)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{fn}: float32 only, got {x.dtype}")
    d = x.shape[-1]
    N = A.shape[-1]
    R = x_proj_w.shape[1] - 2 * N
    if not (0 < N <= MAX_STATE and 0 < R <= MAX_RANK):
        raise ValueError(f"{fn}: d_state {N} (max {MAX_STATE}), dt rank {R} (max {MAX_RANK})")
    want = {"x_proj_w": (x_proj_w, (4, R + 2 * N, d)), "dt_w": (dt_w, (4, d, R)),
            "A": (A, (4, d, N)), "D": (D, (4, d)), "delta_bias": (delta_bias, (4, d))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32 on {x.device}")
    return N, R


def _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len: int) -> Tuple[int, int]:
    """Validate the inputs; return (N, R)."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"nss_scan: x must be contiguous (B, H, W, d), got {tuple(x.shape)}")
    B, H, W, d = x.shape
    if scan_len < 4 or scan_len % 4 or H % scan_len or W % scan_len:
        raise ValueError(
            f"nss_scan: H and W must be multiples of scan_len (a multiple of 4); got "
            f"{H}x{W}, scan_len {scan_len}. Other shapes take K3 "
            f"(ops/scan_fused_proj.py) on gathered sequences")
    return check_scan_weights("nss_scan", x, x_proj_w, dt_w, A, D, delta_bias)


def nss_scan_plain(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                   scan_len: int = 4, shift: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, 4, H, W, d) in image layout, pooled (B, 4, d) sums over the
    path) in plain PyTorch. On a card, turn TF32 off first for a float32
    reference."""
    B, H, W, d = x.shape
    L = H * W
    ids, inv = (torch.from_numpy(a).long().to(x.device)
                for a in mair_scan_ids(H, W, scan_len, scan_len // 2 if shift else 0))
    N = A.shape[-1]
    R = x_proj_w.shape[1] - 2 * N
    xs = x.reshape(B, L, d)[:, ids]  # (B, 4, L, d), sequence order
    xdbl = torch.einsum("bkld,kcd->bklc", xs, x_proj_w)
    dts = torch.einsum("bklr,kdr->bkld", xdbl[..., :R], dt_w)
    y = selective_scan(xs, dts, A, xdbl[..., R:R + N], xdbl[..., R + N:], D, delta_bias,
                       delta_softplus=True, chunk=256)
    pooled = y.sum(2)
    # inv maps each direction's sequence back to row-major pixel order
    yimg = torch.stack([y[:, k, inv[k]] for k in range(4)], 1)
    return yimg.reshape(B, 4, H, W, d), pooled


def nss_scan(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor, delta_bias: torch.Tensor, scan_len: int = 4,
             shift: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, pooled): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor. ``shift`` takes the shifted NSS table (lead stripe of width
    scan_len / 2). Forward only, float32 only."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len)
    if x.device.type == "cpu":
        return nss_scan_plain(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    params = (x, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("nss_scan: the CUDA kernel has no backward")
    B, H, W, d = x.shape
    L = H * W
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        ids = scan_ids_tensor(H, W, scan_len, scan_len // 2 if shift else 0, x.device)
        y = torch.empty(B, 4, H, W, d, device=x.device, dtype=torch.float32)
        pooled = torch.empty(B, 4, d, device=x.device, dtype=torch.float32)
        scratch = torch.empty(lib.tpuir_nss_scan_scratch_numel(B, L, d, N, R),
                              device=x.device, dtype=torch.float32)
        err = lib.tpuir_nss_scan_f32(
            x.data_ptr(), ids.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(), A.data_ptr(),
            D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(), pooled.data_ptr(),
            scratch.data_ptr(), B, L, d, N, R,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _kernels.check(err, "nss_scan")
    _kernels.LAUNCHES["nss_scan"] += 1
    return y, pooled
