"""K2: MaIR's four-direction NSS selective scan, hand-written for Hopper.

The counterpart of ``tpuir/ops/nss_stripe.py`` (``nss_scan_stripe_pre`` and
``nss_scan_stripe``, square and rectangular tiles). The kernel is
``tpuir_torch/csrc/nss_scan.cu``, in its three bodies: float32 parity
(``tpuir_nss_scan_f32``), serving (``tpuir_nss_scan_bf16``, the TPU
kernel with ``serving=True``: bf16 x and y, x_proj and dt_proj of
bf16-rounded operands summed in float32, B, C and the scan in float32,
pooled summed from the float32 y) and serving with the bf16 recurrence
(``tpuir_nss_scan_recur_bf16``, the TPU kernel with ``serving=True,
recur_bf16=True``: the serving body's projections, then a level-1
recurrence in bf16 restarted at every subchunk of ``rp`` stripe rows and a
float32 level-2 carry chained across the path); its source note gives the
math, what bounds it on the card and what the design does about that. It reads x
through the NSS id table of ``ops/scan_ids.py`` and writes y to each path
position's image pixel, so it returns y directly in image layout: there are
no half-block buffers to recombine.

The serving kernel walks each chunk of each sequence once with a channel's
states across the lanes of a warp; ``serving_chunks`` picks the chunk count
per call from the shape, the card's SM count and the walk's resident blocks
an SM (one chunk where one chunk's walks fill a quarter of the card), and
its x_dbl scratch holds rows packed as the walk stages them (``walk_row``),
which ``nss_scan_serving_stages`` unpacks.

``nss_scan`` is the wrapper: it checks its inputs and raises on anything
the kernel does not take. Every parity call goes through the Function of
``ops/kernel_grad.py`` (the kernel forward, the plain version's backward,
as tpuir's ``custom_vjp``); the serving bodies raise under autograd on the
card. On a CUDA tensor it launches the kernel on the
current stream and counts the launch, under ``nss_scan``, for the serving
body ``nss_scan_serving``, for the recurrence body ``nss_scan_recur_serving``;
on a CPU tensor, and only there, it runs ``nss_scan_plain``, the port of
``tpuir/ops/nss_stripe.py:_reference`` (gather by scan ids, the two
projections, softplus, the plain chunked scan, D*x, pooled sums, inverse
gather), ``nss_scan_serving_plain`` or ``nss_scan_recur_plain``, which are
also what the kernel is held against on the card. ``nss_scan_serving_stages``
and ``nss_scan_recur_stages`` return a body's scratch x_dbl (and the
recurrence's level-2 carries) beside its outputs, for the stage-by-stage
checks of ``utils/serving_check.py``.

x is (B, H, W, d) contiguous, float32 or, serving, bf16. Weights are
float32 as the released checkpoints keep them: ``x_proj_w`` (4, R + 2N, d),
``dt_w`` (4, d, R), ``D`` and ``delta_bias`` (4, d); ``A`` (4, d, N) is
already -exp(A_logs). The serving kernel rounds W_xp and W_dt where it
loads them, so no bf16 weight copy is made.
"""

from __future__ import annotations

from typing import Dict, Tuple

import functools
import math

import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels, kernel_grad
from tpuir_torch.ops.scan_ids import (mair_scan_ids, mair_subchunk_layout, scan_ids_tensor,
                                      subchunk_offsets_tensor)
from tpuir_torch.ops.selective_scan import selective_scan
from tpuir_torch.utils.misc import bf16_rounded

MAX_STATE = 32  # the kernel keeps a channel's states in registers (8, 16 or 32 of them)
MAX_RANK = 64   # dt rank R: W_dt is staged in shared memory
VERT_P = 16     # tpuir's mixer's vert_p: level-1 subchunks of 16 // scan_len rows
LOG2E = math.log2(math.e)

# The serving bodies' walk (csrc/nss_walk.cuh: walk_chunk, K2's and K5's): positions a
# staged tile, warps a block, and the lanes a channel's states take by their
# register ceiling (WalkLanes, G lanes x S states: N 4 as 4 x 1, 8 as 2 x 4,
# 16 as 4 x 4, 32 as 8 x 4).
WALK_TILE = 32
WALK_BLOCK_WARPS = 4
WALK_LANES = {4: 4, 8: 2, 16: 4, 32: 8}
# The walk is latency-bound: a chunk after the first costs its walk twice
# (the end state, then y), against more blocks at once. One walk ran faster
# than two chunks at MaIR-CDN@128, whose blocks are about half of the
# card's resident ones; at enc-1 and dec-1 (0.15-0.18 of the card) a wave
# of chunks ran 1.4-1.7 times as fast as half a wave, and two waves 2-5%
# faster than one (utils/k1s_phases.py --body K2s-layouts, PERF.md §6).
WALK_ONE_CHUNK_SHARE = 0.25
WALK_WAVES = 2


def state_ceiling(N: int) -> int:
    """The register ceiling of N states: 4, 8, 16 or 32."""
    return next(m for m in (4, 8, 16, 32) if N <= m)


def walk_blocks(B: int, d: int, N: int) -> int:
    """Blocks of one chunk of the serving walk: B * 4 sequences of d channels."""
    return B * 4 * -(-d // (WALK_BLOCK_WARPS * 32 // WALK_LANES[state_ceiling(N)]))


def serving_chunks(B: int, L: int, d: int, N: int, sms: int, resident: int) -> Tuple[int, int]:
    """(chunks, positions a chunk) of the serving body's walk over each of
    the B * 4 sequences of L positions, d channels and N states on a card of
    ``sms`` SMs that holds ``resident`` of its blocks an SM: one chunk where
    one chunk's blocks fill WALK_ONE_CHUNK_SHARE of the card, else the most
    chunks whose blocks fill WALK_WAVES waves of it; no more than L has
    tiles, each chunk whole tiles but the last."""
    blocks, card = walk_blocks(B, d, N), resident * sms
    n = 1 if blocks >= card * WALK_ONE_CHUNK_SHARE else min(
        WALK_WAVES * card // blocks, -(-L // WALK_TILE))
    chunk = -(-L // n)
    chunk = -(-chunk // WALK_TILE) * WALK_TILE
    return -(-L // chunk), chunk


def walk_row(N: int, R: int) -> Tuple[int, int, int]:
    """(R4, MAXN, CS) of the serving walk's packed x_dbl rows
    (csrc/nss_walk.cuh: WalkRow): [dt_r (R, zeros to R4) | B (MAXN) | C
    (MAXN)], CS floats."""
    r4, maxn = (R + 3) & ~3, state_ceiling(N)
    return r4, maxn, r4 + 2 * maxn


def unpack_walk_rows(xd: torch.Tensor, N: int, R: int) -> torch.Tensor:
    """The serving walk's packed x_dbl (B, L, 4, CS) as (B, L, 4, R + 2N)."""
    r4, maxn, _ = walk_row(N, R)
    return torch.cat([xd[..., :R], xd[..., r4:r4 + N], xd[..., r4 + maxn:r4 + maxn + N]], -1)


def check_scan_weights(fn: str, x, x_proj_w, dt_w, A, D, delta_bias,
                       x_dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """Validate x's device and dtype (``x_dtype``: bf16 for K2's serving
    body) and the four directions' float32 scan weights against x's last
    (channel) dimension, for the wrapper named ``fn`` (K2, K3, K5); return
    (N, R)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype != x_dtype:
        raise TypeError(f"{fn}: x must be {x_dtype}, got {x.dtype}")
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


def _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len: int,
           serving: bool) -> Tuple[int, int]:
    """Validate the inputs; return (N, R)."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"nss_scan: x must be contiguous (B, H, W, d), got {tuple(x.shape)}")
    B, H, W, d = x.shape
    if scan_len < 4 or scan_len % 4 or H % scan_len or W % scan_len:
        raise ValueError(
            f"nss_scan: H and W must be multiples of scan_len (a multiple of 4); got "
            f"{H}x{W}, scan_len {scan_len}. Other shapes take K3 "
            f"(ops/scan_fused_proj.py) on gathered sequences")
    return check_scan_weights("nss_scan", x, x_proj_w, dt_w, A, D, delta_bias,
                              torch.bfloat16 if serving else torch.float32)


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
                       delta_softplus=True, chunk=256, dtype=x.dtype)
    pooled = y.sum(2)
    # inv maps each direction's sequence back to row-major pixel order
    yimg = torch.stack([y[:, k, inv[k]] for k in range(4)], 1)
    return yimg.reshape(B, 4, H, W, d), pooled


def seq_scan_from_xdbl(xs: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor,
                       A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor
                       ) -> torch.Tensor:
    """The serving bodies' scan on sequences from their x_dbl, in xdbl's
    dtype (K3's, and K2's and K5's once gathered): dt =
    softplus(bf16(x_dbl[:R]) . bf16(W_dt)^T + bias), B and C the unrounded
    columns of x_dbl, then the chunked scan and D*xs. xs (B, 4, L, d)
    widened, xdbl (B, 4, L, R + 2N). Returns y (B, 4, L, d)."""
    N = A.shape[-1]
    R = xdbl.shape[-1] - 2 * N
    dts = torch.einsum("bklr,kdr->bkld", bf16_rounded(xdbl[..., :R]),
                       bf16_rounded(dt_w.to(xdbl.dtype)))
    return selective_scan(xs, dts, A, xdbl[..., R:R + N], xdbl[..., R + N:], D, delta_bias,
                          delta_softplus=True, chunk=256, dtype=xdbl.dtype)


def scan_from_xdbl(x: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor, A: torch.Tensor,
                   D: torch.Tensor, delta_bias: torch.Tensor, H: int, W: int, scan_len: int,
                   shift: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving body's scan from its x_dbl, in xdbl's dtype: the path's
    sequences gathered, then ``seq_scan_from_xdbl``. x (B, L, d) widened,
    xdbl (B, L, 4, R + 2N) pixel-major as the kernel's scratch. Returns (y
    (B, 4, H, W, d) unrounded, in image layout; pooled (B, 4, d), the sum of
    y over the path)."""
    B, L, d = x.shape
    ids, inv = (torch.from_numpy(a).long().to(x.device)
                for a in mair_scan_ids(H, W, scan_len, scan_len // 2 if shift else 0))
    xs = x[:, ids]  # (B, 4, L, d), sequence order
    xd = torch.stack([xdbl[:, ids[k], k] for k in range(4)], 1)  # (B, 4, L, C)
    y = seq_scan_from_xdbl(xs, xd, dt_w, A, D, delta_bias)
    yimg = torch.stack([y[:, k, inv[k]] for k in range(4)], 1)
    return yimg.reshape(B, 4, H, W, d), y.sum(2)


def scan_serving_values(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                        A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                        scan_len: int = 4, shift: bool = False) -> Dict[str, torch.Tensor]:
    """The serving body in plain float32 PyTorch, stage by stage as
    ``tpuir/ops/nss_stripe.py:_forward_core(serving=True)`` computes it:
    ``x_dbl`` = bf16(x) . bf16(W_xp)^T summed in float32 (B, L, 4, C), then
    ``scan_from_xdbl``; ``y`` (B, 4, H, W, d) rounded to bf16, ``pooled``
    the float32 sum of the unrounded y."""
    B, H, W, d = x.shape
    xw = x.reshape(B, H * W, d).float()
    xdbl = torch.einsum("bld,kcd->blkc", xw, bf16_rounded(x_proj_w)).contiguous()
    y, pooled = scan_from_xdbl(xw, xdbl, dt_w, A, D, delta_bias, H, W, scan_len, shift)
    return {"x_dbl": xdbl, "y": y.to(torch.bfloat16), "pooled": pooled}


def nss_scan_serving_plain(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                           A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                           scan_len: int = 4, shift: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, 4, H, W, d) bf16 in image layout, pooled (B, 4, d) float32):
    the serving body in plain PyTorch. On a card, turn TF32 off first for a
    float32 reference."""
    st = scan_serving_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    return st["y"], st["pooled"]


# --- the bf16-recurrence serving body --------------------------------------


def _recur_level1(dt, du, Bc, A2, layout, emit=None):
    """tpuir's bf16 level 1 over each subchunk of ``layout`` (4, S, P) for
    one image: dt, du = dt * x (1, 4, L, d) and B (1, 4, L, N) in sequence
    order, A2 = A log2 e (4, d, N). Slots past a subchunk's end are identity
    steps. ``emit(p, hA, hB)`` sees the states after slot p; returns the
    end states (1, 4, S, d, N), bf16 values as float32."""
    kk = torch.arange(4, device=dt.device)[:, None]
    idx, live = layout.clamp(min=0), layout >= 0
    hA = torch.ones(1, 4, layout.shape[1], dt.shape[-1], A2.shape[-1], device=dt.device)
    hB = torch.zeros_like(hA)
    for p in range(layout.shape[2]):
        i = idx[:, :, p]
        av = bf16_rounded(torch.exp2(dt[:, kk, i, :, None] * A2[None, :, None]))
        bv = bf16_rounded(Bc[:, kk, i, None, :] * du[:, kk, i, :, None])
        if p:
            av, bv = bf16_rounded(av * hA), bf16_rounded(bf16_rounded(av * hB) + bv)
        lv = live[None, :, :, p, None, None]
        hA, hB = torch.where(lv, av, hA), torch.where(lv, bv, hB)
        if emit is not None:
            emit(p, hA, hB)
    return hA, hB


def recur_dt(xd: torch.Tensor, dt_w: torch.Tensor, delta_bias: torch.Tensor) -> torch.Tensor:
    """The recurrence body's dt from x_dbl rows xd (B, 4, L, R + 2N) float32:
    softplus of the exact products bf16(x_dbl[r]) bf16(W_dt[k, :, r]) summed
    in rank order in float32, plus the bias. (B, 4, L, d) float32."""
    R = dt_w.shape[-1]
    wd = bf16_rounded(dt_w.float())
    acc = torch.zeros(*xd.shape[:3], dt_w.shape[1], device=xd.device)
    for r in range(R):
        acc = acc + bf16_rounded(xd[..., r:r + 1]) * wd[None, :, None, :, r]
    return F.softplus(acc + delta_bias[None, :, None, :])


def recur_scan(xs: torch.Tensor, xd: torch.Tensor, dt_w: torch.Tensor, A: torch.Tensor,
               D: torch.Tensor, delta_bias: torch.Tensor, layout: torch.Tensor,
               count: torch.Tensor, y_dtype: torch.dtype = torch.float32,
               magnitude: bool = False) -> Tuple[torch.Tensor, ...]:
    """The two-level bf16 recurrence on the sequences xs (B, 4, L, d)
    (widened bf16 x) and their x_dbl rows xd (B, 4, L, R + 2N), at the
    rounding points of ``tpuir/ops/nss_stripe.py``'s recur_bf16 body as it
    runs on the CPU (see ``csrc/nss_scan.cu``). Returns (y (B, 4, L, d) in
    ``y_dtype``, unrounded: sum_n h C_n + D x with h = bf16(hA bf16(cc)) + hB
    float32; carries (B, 4, S, d, N) float32, the level-2 carry cc at each
    subchunk's start, 0 past a direction's last subchunk), and with
    ``magnitude`` a third, sum_n |h C_n| + |D x| (B, 4, L, d) in ``y_dtype``,
    the scale of y's rounding error."""
    B, _, L, d = xs.shape
    N = A.shape[-1]
    R = xd.shape[-1] - 2 * N
    dev = xs.device
    A2 = A.float() * LOG2E
    S, P = layout.shape[1:]
    ends = []
    per_image = []
    for b in range(B):
        dt = recur_dt(xd[b:b + 1].float(), dt_w, delta_bias.float())
        du = dt * xs[b:b + 1].float()
        Bc = xd[b:b + 1, ..., R:R + N].float()
        per_image.append((dt, du, Bc))
        ends.append(_recur_level1(dt, du, Bc, A2, layout))
    HA = torch.cat([e[0] for e in ends])
    HB = torch.cat([e[1] for e in ends])
    # level 2: the float32 carry chained over the subchunks, a multiply and an add
    carries = torch.zeros(B, 4, S, d, N, device=dev)
    cc = torch.zeros(B, 4, d, N, device=dev)
    for j in range(S):
        carries[:, :, j] = cc
        cc = HA[:, :, j] * cc + HB[:, :, j]
    for k in range(4):
        carries[:, k, int(count[k]):] = 0
    ce = bf16_rounded(carries)
    kk = torch.arange(4, device=dev)[:, None]
    idx, live = layout.clamp(min=0), layout >= 0
    y = torch.zeros(B, 4, L, d, device=dev, dtype=y_dtype)
    mag = torch.zeros_like(y) if magnitude else None
    Dk = D.to(y_dtype)[None, :, None, :]
    for b, (dt, du, Bc) in enumerate(per_image):
        Cc = xd[b:b + 1, ..., R + N:].to(y_dtype)
        xb = xs[b:b + 1].to(y_dtype)

        def emit(p, hA, hB, b=b, Cc=Cc, xb=xb):
            h = bf16_rounded(hA * ce[b:b + 1]) + hB
            i = idx[:, :, p]
            hc, dx = h.to(y_dtype) * Cc[:, kk, i, None, :], Dk * xb[:, kk, i]
            ks, ss = live[:, :, p].nonzero(as_tuple=True)
            y[b, ks, i[ks, ss]] = (hc.sum(-1) + dx)[0, ks, ss]
            if mag is not None:
                mag[b, ks, i[ks, ss]] = (hc.abs().sum(-1) + dx.abs())[0, ks, ss]

        _recur_level1(dt, du, Bc, A2, layout, emit)
    return (y, carries, mag) if magnitude else (y, carries)


def recur_from_xdbl(x: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor, A: torch.Tensor,
                    D: torch.Tensor, delta_bias: torch.Tensor, H: int, W: int, scan_len: int,
                    shift: bool, y_dtype: torch.dtype = torch.float32, vert_p: int = VERT_P,
                    magnitude: bool = False) -> Tuple[torch.Tensor, ...]:
    """The recurrence body from its x_dbl: x (B, L, d) widened, xdbl (B, L,
    4, R + 2N) pixel-major as the kernel's scratch. Returns (y (B, 4, H, W,
    d) unrounded in ``y_dtype``, in image layout; pooled (B, 4, d), the sum
    of y over the path; carries (B, 4, S, d, N)), and with ``magnitude``
    ``recur_scan``'s magnitude of y in image layout."""
    B, L, d = x.shape
    sl = scan_len // 2 if shift else 0
    ids, inv = (torch.from_numpy(a).long().to(x.device)
                for a in mair_scan_ids(H, W, scan_len, sl))
    layout, count = mair_subchunk_layout(H, W, scan_len, sl, vert_p)
    xs = x[:, ids]  # (B, 4, L, d), sequence order
    xd = torch.stack([xdbl[:, ids[k], k] for k in range(4)], 1)  # (B, 4, L, C)
    out = recur_scan(xs, xd, dt_w, A, D, delta_bias, torch.from_numpy(layout).to(x.device),
                     count, y_dtype, magnitude)
    img = [torch.stack([t[:, k, inv[k]] for k in range(4)], 1).reshape(B, 4, H, W, d)
           for t in (out[0], *out[2:])]
    return (img[0], out[0].sum(2), out[1], *img[1:])


def scan_recur_values(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                      A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                      scan_len: int = 4, shift: bool = False) -> Dict[str, torch.Tensor]:
    """The bf16-recurrence serving body in plain float32 PyTorch, stage by
    stage: ``x_dbl`` = bf16(x) . bf16(W_xp)^T summed in float32 (B, L, 4, C)
    as the serving body's, then ``recur_from_xdbl``: ``carries`` the level-2
    carries, ``y`` (B, 4, H, W, d) rounded to bf16, ``pooled`` the float32
    sum of the unrounded y."""
    B, H, W, d = x.shape
    xw = x.reshape(B, H * W, d).float()
    xdbl = torch.einsum("bld,kcd->blkc", xw, bf16_rounded(x_proj_w)).contiguous()
    y, pooled, carries = recur_from_xdbl(xw, xdbl, dt_w, A, D, delta_bias, H, W, scan_len,
                                         shift)
    return {"x_dbl": xdbl, "carries": carries, "y": y.to(torch.bfloat16), "pooled": pooled}


def nss_scan_recur_plain(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                         A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                         scan_len: int = 4, shift: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, 4, H, W, d) bf16 in image layout, pooled (B, 4, d) float32):
    the bf16-recurrence serving body in plain PyTorch."""
    st = scan_recur_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    return st["y"], st["pooled"]


@functools.lru_cache(maxsize=None)
def walk_capacity(device: torch.device, N: int, R: int,
                  query: str = "tpuir_nss_scan_bf16_resident_blocks") -> Tuple[int, int]:
    """(SMs, blocks of a serving walk an SM holds) on ``device``, the blocks
    from the library's resident-block ``query`` for that walk's instance
    (K2's by default; K5's is ``ops/nss_fused.RESIDENT_BLOCKS``)."""
    with torch.cuda.device(device):
        resident = getattr(_kernels.library(), query)(N, R)
    if resident <= 0:
        raise RuntimeError(f"{query}: no block of the serving walk fits an SM ({resident})")
    return torch.cuda.get_device_properties(device).multi_processor_count, resident


def _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R,
            serving, recur=False, carries=False) -> Dict[str, torch.Tensor]:
    """One launch of a body on x's card: {x_dbl (B, L, 4, R + 2N; the
    serving walk's packed rows, B, L, 4, CS), y, pooled}, and with
    ``carries`` the recurrence body's level-2 carries."""
    params = (x, x_proj_w, dt_w, A, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError("nss_scan: the CUDA kernel has no backward")
    B, H, W, d = x.shape
    if serving and not recur and d % 2:
        raise ValueError(f"nss_scan: the serving kernel stages x two channels a copy and "
                         f"needs an even d, got {d}")
    L = H * W
    sl = scan_len // 2 if shift else 0
    lib = _kernels.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ids = scan_ids_tensor(H, W, scan_len, sl, x.device)
        y = torch.empty(B, 4, H, W, d, device=x.device, dtype=x.dtype)
        pooled = torch.empty(B, 4, d, device=x.device, dtype=torch.float32)
        if recur:
            off = subchunk_offsets_tensor(H, W, scan_len, sl, x.device, VERT_P)
            S = off.shape[1] - 1
            scratch = torch.empty(lib.tpuir_nss_scan_recur_scratch_numel(B, L, d, N, R, S),
                                  device=x.device, dtype=torch.float32)
            cc = torch.empty(B, 4, S, d, N, device=x.device, dtype=torch.float32)
            err = lib.tpuir_nss_scan_recur_bf16(
                x.data_ptr(), ids.data_ptr(), off.data_ptr(), x_proj_w.data_ptr(),
                dt_w.data_ptr(), A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
                pooled.data_ptr(), scratch.data_ptr(), cc.data_ptr(), S, B, L, d, N, R, stream)
        elif serving:
            _, chunk = serving_chunks(B, L, d, N, *walk_capacity(x.device, N, R))
            scratch = torch.empty(lib.tpuir_nss_scan_bf16_scratch_numel(B, L, d, N, R, chunk),
                                  device=x.device, dtype=torch.float32)
            err = lib.tpuir_nss_scan_bf16(
                x.data_ptr(), ids.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(),
                A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
                pooled.data_ptr(), scratch.data_ptr(), B, L, d, N, R, chunk, stream)
        else:
            scratch = torch.empty(lib.tpuir_nss_scan_scratch_numel(B, L, d, N, R),
                                  device=x.device, dtype=torch.float32)
            err = lib.tpuir_nss_scan_f32(
                x.data_ptr(), ids.data_ptr(), x_proj_w.data_ptr(), dt_w.data_ptr(),
                A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
                pooled.data_ptr(), scratch.data_ptr(), B, L, d, N, R, stream)
    _kernels.check(err, _launch_name(serving, recur))
    cs = walk_row(N, R)[2] if serving and not recur else R + 2 * N
    xdbl = scratch[:B * L * 4 * cs].view(B, L, 4, cs)
    out = {"x_dbl": xdbl, "y": y, "pooled": pooled}
    if carries:
        out["carries"] = cc
    return out


def _launch_name(serving: bool, recur: bool) -> str:
    return "nss_scan_recur_serving" if recur else (
        "nss_scan_serving" if serving else "nss_scan")


def nss_scan(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor, delta_bias: torch.Tensor, scan_len: int = 4,
             shift: bool = False, serving: bool = False,
             recur_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, pooled): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor. ``shift`` takes the shifted NSS table (lead stripe of width
    scan_len / 2). x and y float32 or, with ``serving``, bf16;
    pooled float32. ``recur_bf16`` (serving only) takes the bf16-recurrence
    body. The parity body is differentiable (``ops/kernel_grad.py``: the
    plain version's gradient); the serving bodies are forward only."""
    if recur_bf16 and not serving:
        raise ValueError("nss_scan: recur_bf16 is a serving body; pass serving=True")
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, serving)
    params = (x, x_proj_w, dt_w, A, D, delta_bias)
    if not serving:
        return _parity_grad(params, (scan_len, shift))
    if x.device.type == "cpu":
        plain = nss_scan_recur_plain if recur_bf16 else nss_scan_serving_plain
        return plain(*params, scan_len, shift)
    out = _launch(*params, scan_len, shift, N, R, True, recur_bf16)
    _kernels.LAUNCHES[_launch_name(True, recur_bf16)] += 1
    return out["y"], out["pooled"]


def _parity_kernel(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift):
    """(y, pooled) from one counted launch of the parity body on x's card."""
    N = A.shape[-1]
    out = _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N,
                  x_proj_w.shape[1] - 2 * N, False)
    _kernels.LAUNCHES["nss_scan"] += 1
    return out["y"], out["pooled"]


# tpuir/ops/nss_stripe.py:_stripe_vjp: the kernel forward, the plain backward
_parity_grad = kernel_grad.differentiable(_parity_kernel, nss_scan_plain)


def nss_scan_serving_stages(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                            A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                            scan_len: int = 4, shift: bool = False) -> Dict[str, torch.Tensor]:
    """The serving kernel's outputs and its scratch from one launch on x's
    card, for a check (``utils/serving_check.py``); counts no launch:
    ``x_dbl`` (B, L, 4, R + 2N) float32 (the kernel's packed rows unpacked),
    ``y`` (bf16) and ``pooled``. On a CPU tensor, and only there, the same
    stages of the plain version."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, True)
    if x.device.type == "cpu":
        return scan_serving_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    out = _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R, True)
    out["x_dbl"] = unpack_walk_rows(out["x_dbl"], N, R)
    return out


def nss_scan_recur_stages(x: torch.Tensor, x_proj_w: torch.Tensor, dt_w: torch.Tensor,
                          A: torch.Tensor, D: torch.Tensor, delta_bias: torch.Tensor,
                          scan_len: int = 4, shift: bool = False) -> Dict[str, torch.Tensor]:
    """The bf16-recurrence kernel's outputs, its scratch x_dbl and its
    level-2 carries (B, 4, S, d, N) from one launch on x's card, for a check
    (``utils/serving_check.py``); counts no launch. On a CPU tensor, and
    only there, the same stages of the plain version."""
    N, R = _check(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, True)
    if x.device.type == "cpu":
        return scan_recur_values(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift)
    return _launch(x, x_proj_w, dt_w, A, D, delta_bias, scan_len, shift, N, R, True,
                   recur=True, carries=True)
