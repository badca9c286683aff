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
launches. All math is float32. This is the plain version the K2 kernel
(``ops/nss_stripe.py``) is held against, not a kernel of its own.
"""

from __future__ import annotations

from typing import Optional

import torch


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
) -> torch.Tensor:
    """Batched over (B, K) directions. Returns y: (B, K, L, D) float32."""
    u = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[None, :, None, :]
    if delta_softplus:
        dt = softplus(dt)
    A = A.float()[None, :, None]  # (1, K, 1, D, N)
    Bmat, Cmat = Bmat.float(), Cmat.float()
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
        y = y + D.float()[None, :, None, :] * u
    return y
