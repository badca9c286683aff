"""Selective scan (the Mamba S6 recurrence), plain PyTorch.

The port of ``tpuir/ops/selective_scan.py:selective_scan``, in the same
chunked form. Over L positions, per (batch, direction, channel d, state n):

    dt_t = softplus(delta_t + delta_bias)
    h_t  = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) * u_t
    y_t  = C_t . h_t + D * u_t

The recurrence is first-order linear, so inside a chunk it is an inclusive
scan under the combine (a2, b2) o (a1, b1) = (a2*a1, a2*b1 + b2), taken
here in log2(chunk) Hillis-Steele steps; an outer loop over chunks carries
h. A position-by-position loop would be the same math at L times the
launches. All math is float32 (float64 for a reference). ``selective_scan``
is the plain version that the scan kernels (K2, K3, K5) are held against
through their own plain versions, and the plain version of K4.

``selective_scan_kernel`` is K4's wrapper, the counterpart of
``tpuir/ops/scan_pallas.py:selective_scan_pallas`` (mamba_ssm's
``selective_scan_fn``: delta, B and C given, no projections). The kernel is
``tpuir_torch/csrc/selective_scan.cu``, on the chunked scan of
``csrc/chunk_scan.cuh``. On a CUDA tensor the wrapper launches it on the
current stream and counts the launch; on a CPU tensor, and only there, it
runs ``selective_scan``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuir_torch.ops import _kernels

MAX_STATE = 32  # the kernel keeps a channel's states in registers (8, 16 or 32 of them)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (no threshold)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Hillis-Steele inclusive scan of (a, b) pairs along ``dim``."""
    n = a.shape[dim]
    step = 1
    while step < n:
        a_head, b_head = a.narrow(dim, 0, step), b.narrow(dim, 0, step)
        a_prev, b_prev = a.narrow(dim, 0, n - step), b.narrow(dim, 0, n - step)
        a_cur, b_cur = a.narrow(dim, step, n - step), b.narrow(dim, step, n - step)
        b = torch.cat([b_head, a_cur * b_prev + b_cur], dim)
        a = torch.cat([a_head, a_cur * a_prev], dim)
        step *= 2
    return a, b


def selective_scan(
    u: torch.Tensor,  # (B, K, L, D)
    delta: torch.Tensor,  # (B, K, L, D)
    A: torch.Tensor,  # (K, D, N), already -exp(A_log)
    Bmat: torch.Tensor,  # (B, K, L, N)
    Cmat: torch.Tensor,  # (B, K, L, N)
    D: Optional[torch.Tensor] = None,  # (K, D)
    delta_bias: Optional[torch.Tensor] = None,  # (K, D)
    delta_softplus: bool = True,
    chunk: int = 256,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Batched over (B, K) directions. Returns y: (B, K, L, D) in ``dtype``
    (float32; float64 for a reference)."""
    u = u.to(dtype)
    dt = delta.to(dtype)
    if delta_bias is not None:
        dt = dt + delta_bias.to(dtype)[None, :, None, :]
    if delta_softplus:
        dt = softplus(dt)
    A = A.to(dtype)[None, :, None]  # (1, K, 1, D, N)
    Bmat, Cmat = Bmat.to(dtype), Cmat.to(dtype)
    nb, nk, L, d = u.shape
    h = u.new_zeros(nb, nk, d, A.shape[-1])
    ys = []
    for s in range(0, L, chunk):
        e = min(L, s + chunk)
        dt_c, u_c = dt[:, :, s:e], u[:, :, s:e]
        a = torch.exp(dt_c[..., None] * A)  # (B, K, c, D, N)
        b = (dt_c * u_c)[..., None] * Bmat[:, :, s:e, None, :]
        a_cum, b_cum = _inclusive_scan(a, b, 2)
        hs = a_cum * h[:, :, None] + b_cum
        ys.append((hs * Cmat[:, :, s:e, None, :]).sum(-1))
        h = hs[:, :, -1]
    y = torch.cat(ys, 2)
    if D is not None:
        y = y + D.to(dtype)[None, :, None, :] * u
    return y


def selective_scan_kernel(
    u: torch.Tensor,  # (B, K, L, D)
    delta: torch.Tensor,  # (B, K, L, D)
    A: torch.Tensor,  # (K, D, N), already -exp(A_log)
    Bmat: torch.Tensor,  # (B, K, L, N)
    Cmat: torch.Tensor,  # (B, K, L, N)
    D: Optional[torch.Tensor] = None,  # (K, D)
    delta_bias: Optional[torch.Tensor] = None,  # (K, D)
    delta_softplus: bool = True,
) -> torch.Tensor:
    """K4, the port of ``tpuir/ops/scan_pallas.py:117 selective_scan_pallas``:
    y (B, K, L, D) float32, from the CUDA kernel on a CUDA tensor and from
    ``selective_scan`` on a CPU tensor. The kernel fuses the softplus, so
    ``delta_softplus=False`` raises, as the JAX function asserts; an absent
    D or delta_bias counts as zeros. Forward only, float32 only."""
    if not delta_softplus:
        raise ValueError("selective_scan_kernel: the kernel fuses softplus; "
                         "delta_softplus=False is not supported")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan_kernel: unsupported device {u.device}")
    if u.dtype != torch.float32:
        raise TypeError(f"selective_scan_kernel: float32 only, got {u.dtype}")
    if u.dim() != 4:
        raise ValueError(f"selective_scan_kernel: u must be (B, K, L, D), got {tuple(u.shape)}")
    nb, nk, L, d = u.shape
    N = A.shape[-1]
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"selective_scan_kernel: d_state {N} (max {MAX_STATE})")
    want = {"u": (u, (nb, nk, L, d)), "delta": (delta, (nb, nk, L, d)), "A": (A, (nk, d, N)),
            "Bmat": (Bmat, (nb, nk, L, N)), "Cmat": (Cmat, (nb, nk, L, N)),
            "D": (D, (nk, d)), "delta_bias": (delta_bias, (nk, d))}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(
                f"selective_scan_kernel: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != u.device or not t.is_contiguous():
            raise ValueError(
                f"selective_scan_kernel: {name} must be contiguous float32 on {u.device}")
    if u.device.type == "cpu":
        return selective_scan(u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus=True)
    params = [t for t in (u, delta, A, Bmat, Cmat, D, delta_bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("selective_scan_kernel: the CUDA kernel has no backward")
    lib = _kernels.library()
    with torch.cuda.device(u.device):
        zeros = torch.zeros(nk, d, device=u.device, dtype=torch.float32)
        D = zeros if D is None else D
        delta_bias = zeros if delta_bias is None else delta_bias
        y = torch.empty_like(u)
        scratch = torch.empty(lib.tpuir_selective_scan_scratch_numel(nb, nk, L, d, N),
                              device=u.device, dtype=torch.float32)
        err = lib.tpuir_selective_scan_f32(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            nb, nk, L, d, N, torch.cuda.current_stream(u.device).cuda_stream,
        )
    _kernels.check(err, "selective_scan")
    _kernels.LAUNCHES["selective_scan"] += 1
    return y
