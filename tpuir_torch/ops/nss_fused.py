"""K5: MaIR's gather-free four-direction NSS selective scan, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_fused.py:nss_scan_fused``, which MaIR's
mixers take under ``TPUIR_NSS=fused`` (the port's ``nss="fused"``) on
levels whose H and W are multiples of ``scan_len``. The kernel is
``tpuir_torch/csrc/nss_fused.cu``, on the chunked scan it shares with K2
and K4 (``csrc/chunk_scan.cuh``), in its two bodies: float32 parity
(``tpuir_nss_scan_fused_f32``) and serving (``tpuir_nss_scan_fused_bf16``,
the TPU kernel with ``serving=True``: bf16 x and y, x_proj and dt_proj of
bf16-rounded operands summed in float32, B, C and the scan in float32,
pooled summed from the float32 y); its source note gives the math, what
bounds it on the card and what the design does about that. It computes the
pixel each path position visits from the stripe arithmetic, with no id
table, and writes y straight into the JAX function's output layouts.

``nss_scan_fused`` is the wrapper: it raises ``ValueError`` where the JAX
function does (odd ``scan_len``; H or W not a multiple of it) and on
anything the kernel does not take. On a CUDA tensor it launches the kernel
on the current stream and counts the launch, under ``nss_scan_fused`` or,
for the serving body, ``nss_scan_fused_serving``; on a CPU tensor, and only
there, it runs ``nss_scan_fused_plain``, the port of
``tpuir/ops/nss_fused.py:_reference`` (the id table of ``ops/scan_ids.py``,
einsum projections, the plain chunked scan, the inverse gather), or
``nss_scan_fused_serving_plain`` (K2's serving body in plain PyTorch,
``ops/nss_stripe.scan_serving_values``, in K5's output layouts), which are
also what the kernel is held against on the card: the table against the
arithmetic. ``nss_scan_fused_serving_stages`` returns the serving body's
scratch x_dbl beside its outputs, for the stage-by-stage check of
``utils/serving_check.py``.

x is (B, H, W, d) contiguous, float32 or, serving, bf16. Weights are
float32 as the released checkpoints keep them: ``x_proj_w`` (4, R + 2N,
d), ``dt_w`` (4, d, R), ``D`` and ``delta_bias`` (4, d); ``A`` (4, d, N) is
already -exp(A_logs). Returns (y01 (B, 2, H, W, d), y23 (B, 2, W, H, d),
pooled (B, 4, d)) with y01 and y23 of x's dtype and pooled float32: y23[b,
k, w, h] is direction k + 2's output for pixel (h, w), and pooled the sums
of the float32 y over each path. The serving kernel rounds W_xp and W_dt
where it loads them, so no bf16 weight copy is made.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_stripe import check_scan_weights, scan_serving_values
from tpuir_torch.ops.scan_ids import scan_index_tensors
from tpuir_torch.ops.selective_scan import selective_scan


def _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len: int,
           serving: bool = False) -> Tuple[int, int]:
    """Validate the inputs; return (N, R)."""
    if scan_len % 2 != 0:
        raise ValueError(f"nss_scan_fused: scan_len must be even; got {scan_len}")
    if x.dim() != 4 or x.shape[1] % scan_len or x.shape[2] % scan_len:
        raise ValueError(
            f"nss_scan_fused: H and W must be multiples of scan_len (directions 2/3 stripe "
            f"the transposed image); got {tuple(x.shape)}, scan_len {scan_len}")
    if not x.is_contiguous():
        raise ValueError("nss_scan_fused: x must be contiguous (B, H, W, d)")
    return check_scan_weights("nss_scan_fused", x, x_proj_w, dt_w, A, D, delta_bias,
                              torch.bfloat16 if serving else torch.float32)


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


def fused_serving_values(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                         A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                         scan_len: int = 4, shift: bool = False) -> Dict[str, torch.Tensor]:
    """The serving body in plain float32 PyTorch, stage by stage as
    ``tpuir/ops/nss_fused.py:_seq_scan_call(serving=True)`` computes it:
    K2's serving stages (``ops/nss_stripe.scan_serving_values``, the same
    path and roundings: ``x_dbl`` (B, L, 4, C) pixel-major, as the kernel's
    scratch) with y as ``y01`` and ``y23`` (bf16) and ``pooled`` the float32
    sum of the unrounded y."""
    st = scan_serving_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    y = st["y"]  # (B, 4, H, W, d) in image layout
    return {"x_dbl": st["x_dbl"], "y01": y[:, :2], "y23": y[:, 2:].transpose(2, 3),
            "pooled": st["pooled"]}


def nss_scan_fused_serving_plain(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                                 A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                                 scan_len: int = 4, shift: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y01, y23 bf16, pooled float32) from a bf16 x: the serving body in
    plain PyTorch. On a card, turn TF32 off first for a float32 reference."""
    st = fused_serving_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    return st["y01"], st["y23"], st["pooled"]


def _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R,
            serving) -> Dict[str, torch.Tensor]:
    """One launch of a body on x's card: {y01, y23, pooled, x_dbl}, x_dbl a
    view of the kernel's scratch."""
    params = (x, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("nss_scan_fused: the CUDA kernel has no backward")
    B, H, W, d = x.shape
    lib = _kernels.library()
    fn = lib.tpuir_nss_scan_fused_bf16 if serving else lib.tpuir_nss_scan_fused_f32
    with torch.cuda.device(x.device):
        y = torch.empty(B, 4, H * W, d, device=x.device, dtype=x.dtype)
        pooled = torch.empty(B, 4, d, device=x.device, dtype=torch.float32)
        # K2's scratch layout: x_dbl, chunk states and decay products, partials
        scratch = torch.empty(lib.tpuir_nss_scan_scratch_numel(B, H * W, d, N, R),
                              device=x.device, dtype=torch.float32)
        err = fn(x.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(), A.data_ptr(), D.data_ptr(),
                 delta_bias.data_ptr(), y.data_ptr(), pooled.data_ptr(), scratch.data_ptr(),
                 B, H, W, d, N, R, scan_len, int(shift),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "nss_scan_fused_serving" if serving else "nss_scan_fused")
    xdbl = scratch[:B * H * W * 4 * (R + 2 * N)].view(B, H * W, 4, R + 2 * N)
    return {"y01": y[:, :2].view(B, 2, H, W, d), "y23": y[:, 2:].view(B, 2, W, H, d),
            "pooled": pooled, "x_dbl": xdbl}


def nss_scan_fused(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                   scan_len: int = 4, shift: bool = False, serving: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y01, y23, pooled): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. ``shift`` takes the shifted NSS path (lead
    stripe of width scan_len / 2). Forward only; x, y01 and y23 float32 or,
    with ``serving``, bf16; pooled float32. The kernel's y01 and y23 are
    views of one (B, 4, H*W, d) buffer."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, serving)
    if x.device.type == "cpu":
        plain = nss_scan_fused_serving_plain if serving else nss_scan_fused_plain
        return plain(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    out = _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R, serving)
    _kernels.LAUNCHES["nss_scan_fused_serving" if serving else "nss_scan_fused"] += 1
    return out["y01"], out["y23"], out["pooled"]


def nss_scan_fused_serving_stages(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                                  A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                                  scan_len: int = 4, shift: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """The serving kernel's outputs and its scratch from one launch on x's
    card, for a check (``utils/serving_check.py``); counts no launch:
    ``x_dbl`` (B, L, 4, R + 2N) float32, ``y01`` and ``y23`` (bf16) and
    ``pooled``. On a CPU tensor, and only there, the same stages of the
    plain version."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, True)
    if x.device.type == "cpu":
        return fused_serving_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    return _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R, True)
