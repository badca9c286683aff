"""K5: MaIR's gather-free four-direction NSS selective scan, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_fused.py:nss_scan_fused``, which MaIR's
mixers take under ``TPUIR_NSS=fused`` (the port's ``nss="fused"``) on
levels whose H and W are multiples of ``scan_len``. The kernel is
``tpuir_torch/csrc/nss_fused.cu``, in its two bodies: float32 parity
(``tpuir_nss_scan_fused_f32``, on the chunked passes it shares with K2's
parity body and K4, ``csrc/chunk_scan.cuh``) and serving
(``tpuir_nss_scan_fused_bf16``, the TPU kernel with ``serving=True``: bf16
x and y, x_proj and dt_proj of bf16-rounded operands summed in float32, B,
C and the scan in float32, pooled summed from the float32 y; on the walk it
shares with K2's serving body, ``csrc/nss_walk.cuh``); its source note
gives the math, what bounds it on the card and what the design does about
that. It computes the pixel each path position visits from the stripe
arithmetic, with no id table, and writes y straight into the JAX function's
output layouts.

The serving body walks each chunk of each sequence once with a channel's
states across the lanes of a warp, as K2's does: the wrapper picks the
chunk count with ``ops/nss_stripe.serving_chunks`` from the walk's resident
blocks an SM (``RESIDENT_BLOCKS``, K5's own instance), and the walk's x_dbl
scratch holds packed rows, which ``nss_scan_fused_serving_stages`` unpacks.
On the card it needs an even d (x is staged two channels a copy); the CPU
path and the parity body take any d.

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
from tpuir_torch.ops.nss_stripe import (check_scan_weights, scan_serving_values, serving_chunks,
                                        unpack_walk_rows, walk_capacity, walk_row)
from tpuir_torch.ops.scan_ids import scan_index_tensors
from tpuir_torch.ops.selective_scan import selective_scan

# The serving walk's resident-block query for K5's instance (walk_capacity)
RESIDENT_BLOCKS = "tpuir_nss_scan_fused_bf16_resident_blocks"


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
    view of the kernel's scratch (the serving walk's packed rows, B, L, 4,
    CS)."""
    params = (x, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("nss_scan_fused: the CUDA kernel has no backward")
    B, H, W, d = x.shape
    if serving and d % 2:
        raise ValueError(f"nss_scan_fused: the serving kernel stages x two channels a copy and "
                         f"needs an even d, got {d}")
    L = H * W
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        y = torch.empty(B, 4, L, d, device=x.device, dtype=x.dtype)
        pooled = torch.empty(B, 4, d, device=x.device, dtype=torch.float32)
        args = (x.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(), A.data_ptr(), D.data_ptr(),
                delta_bias.data_ptr(), y.data_ptr(), pooled.data_ptr())
        if serving:
            _, chunk = serving_chunks(B, L, d, N, *walk_capacity(x.device, N, R,
                                                                 RESIDENT_BLOCKS))
            # K2's serving walk's scratch layout: packed x_dbl rows, packed weight, chunks
            scratch = torch.empty(lib.tpuir_nss_scan_bf16_scratch_numel(B, L, d, N, R, chunk),
                                  device=x.device, dtype=torch.float32)
            err = lib.tpuir_nss_scan_fused_bf16(*args, scratch.data_ptr(), B, H, W, d, N, R,
                                                scan_len, int(shift), chunk, stream)
        else:
            # K2's scratch layout: x_dbl, chunk states and decay products, partials
            scratch = torch.empty(lib.tpuir_nss_scan_scratch_numel(B, L, d, N, R),
                                  device=x.device, dtype=torch.float32)
            err = lib.tpuir_nss_scan_fused_f32(*args, scratch.data_ptr(), B, H, W, d, N, R,
                                               scan_len, int(shift), stream)
    _kernels.check(err, "nss_scan_fused_serving" if serving else "nss_scan_fused")
    cs = walk_row(N, R)[2] if serving else R + 2 * N
    xdbl = scratch[:B * L * 4 * cs].view(B, L, 4, cs)
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
    ``x_dbl`` (B, L, 4, R + 2N) float32 (the walk's packed rows unpacked),
    ``y01`` and ``y23`` (bf16) and ``pooled``. On a CPU tensor, and only
    there, the same stages of the plain version."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, True)
    if x.device.type == "cpu":
        return fused_serving_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    out = _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R, True)
    out["x_dbl"] = unpack_walk_rows(out["x_dbl"], N, R)
    return out
