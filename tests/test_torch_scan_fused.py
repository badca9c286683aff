"""K3 in the port (the selective scan with fused projections on gathered
sequences): its plain version against the JAX Pallas kernel in interpret
mode and against the JAX composition it replaces; a float32 emulation of
the CUDA kernel's numerical order (one pass from a zero state, the sum over
the states as the kernel's butterfly folds it) against the JAX kernel; the
butterfly's lane arithmetic; the wrapper's checks; an emulation of a float32
FMA chain, and on a card the plain version's and the kernel's x_dbl against
it; and the CUDA kernel against the plain version on a card.

Inputs come from NumPy seeds. JAX is imported only on the reference side,
so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                             selective_scan_fused_proj_plain)
from tpuir_torch.ops.selective_scan import softplus
from tests.torch_threads import one_torch_thread  # noqa: F401

# the JAX package's tolerance for K3 against its composition
# (tests/test_scan_pallas.py:61)
ATOL, RTOL = 2e-4, 2e-4
# the scan's own, kernel against plain on the card (tests/test_torch_nss.py)
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(B, L, d, n, r, seed):
    """xs and the scan weights as the port takes them (A already -exp), the
    projections scaled by their fan-in so that x_dbl and dt stay unit-scale
    at any width."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        xs=f(B, 4, L, d), x_proj_w=f(4, r + 2 * n, d) / np.float32(np.sqrt(d)),
        dt_w=f(4, d, r) / np.float32(np.sqrt(r)),
        A=-np.exp(f(4, d, n) * np.float32(0.3)).astype(np.float32),
        D=f(4, d) * np.float32(0.3), delta_bias=f(4, d) * np.float32(0.3),
    )


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


@pytest.mark.parametrize("B,L,d,n,r", [
    (1, 64, 24, 4, 2),
    (2, 100, 12, 5, 2),   # ragged L (not a multiple of the chunk) and d
    (1, 70, 40, 32, 3),   # MaIRUNet's latent d_state 32, ragged L
    (1, 48, 20, 16, 2),
])
def test_plain_matches_jax_kernel_and_composition(B, L, d, n, r):
    import jax.numpy as jnp

    from tpuir.ops import scan_pallas as sp

    ops = _operands(B, L, d, n, r, seed=L + n)
    j = [jnp.asarray(ops[k]) for k in ("xs", "x_proj_w", "dt_w", "A", "D", "delta_bias")]
    kern = np.asarray(sp.selective_scan_fused_proj(*j, chunk=16, interpret=True))
    comp = np.asarray(sp._reference_composition(*j, chunk=16))
    before = dict(_kernels.LAUNCHES)
    got = selective_scan_fused_proj(**_torch(ops))
    assert _kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (B, 4, L, d)
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), comp, atol=ATOL, rtol=RTOL)


# the kernel's lanes (csrc/scan_fused_proj.cu:SeqLanes): the ceiling MAXN of
# the states -> (S states a lane, G lanes a channel)
SEQ_LANES = {4: (1, 4), 8: (2, 4), 16: (1, 16), 32: (4, 8)}


def _maxn(n):
    """The kernel's register ceiling of the states."""
    return next(m for m in (4, 8, 16, 32) if n <= m)


def _one_pass(xs, x_proj_w, dt_w, A, D, delta_bias):
    """The CUDA kernel's numerical order in float32 torch
    (``csrc/scan_fused_proj.cu:seq_scan_kernel``): x_dbl, then per position
    dt = softplus(bias + the R terms in order), one pass from a zero state
    with the decay as exp2(dt * A * log2(e)) and the states padded to the
    ceiling with zeros; C . h summed first over a lane's S states in order,
    then over the channel's G lanes by folding in halves (g with g + G/2,
    then g + G/4, ...); then + D*u. The kernel's FMAs are taken here as a
    product and a sum."""
    B, K, L, d = xs.shape
    n = A.shape[-1]
    r = x_proj_w.shape[1] - 2 * n
    maxn = _maxn(n)
    S, G = SEQ_LANES[maxn]
    xdbl = torch.einsum("bkld,kcd->bklc", xs, x_proj_w)
    dr = delta_bias[None, :, None, :].expand(B, K, L, d)
    for j in range(r):
        dr = dr + dt_w[None, :, None, :, j] * xdbl[..., j:j + 1]
    dt = softplus(dr)
    du = dt * xs
    pad = (0, maxn - n)
    A2 = torch.nn.functional.pad(A * np.float32(1.4426950408889634), pad)  # (K, d, maxn)
    Bm = torch.nn.functional.pad(xdbl[..., r:r + n], pad)  # (B, K, L, maxn)
    Cm = torch.nn.functional.pad(xdbl[..., r + n:], pad)
    h = torch.zeros(B, K, d, maxn)
    ys = []
    for t in range(L):
        decay = torch.exp2(dt[:, :, t, :, None] * A2)
        h = decay * h + du[:, :, t, :, None] * Bm[:, :, t, None, :]
        ch = (Cm[:, :, t, None, :] * h).reshape(B, K, d, G, S)
        p = ch[..., 0]
        for s in range(1, S):
            p = p + ch[..., s]
        g = G
        while g > 1:
            g //= 2
            p = p[..., :g] + p[..., g:2 * g]
        ys.append(p[..., 0])
    return torch.stack(ys, 2) + D[None, :, None, :] * xs


@pytest.mark.parametrize("B,L,d,n,r", [
    (1, 45, 12, 4, 2),    # ceiling 4: a state a lane, eight channels a warp
    (2, 33, 10, 5, 2),    # ceiling 8, states past N, L one past a 32-position tile
    (1, 70, 20, 16, 3),   # ceiling 16: 16 lanes a channel, ragged L and d
    (1, 31, 24, 32, 3),   # ceiling 32: four states a lane, L under one tile
])
def test_one_pass_order_matches_jax_kernel(B, L, d, n, r):
    import jax.numpy as jnp

    from tpuir.ops import scan_pallas as sp

    ops = _operands(B, L, d, n, r, seed=3 * L + n)
    j = [jnp.asarray(ops[k]) for k in ("xs", "x_proj_w", "dt_w", "A", "D", "delta_bias")]
    kern = np.asarray(sp.selective_scan_fused_proj(*j, chunk=16, interpret=True))
    got = _one_pass(**_torch(ops))
    assert got.shape == (B, 4, L, d)
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
    # and within the card tolerance of the plain version it is held to there
    want = selective_scan_fused_proj_plain(**_torch(ops))
    torch.testing.assert_close(got, want, atol=SCAN_ATOL, rtol=SCAN_RTOL)


@pytest.mark.parametrize("G", sorted({g for _, g in SEQ_LANES.values()}))
def test_butterfly_leaves_each_lane_its_positions(G):
    """``sum_over_lanes`` of the kernel, lane by lane: 32 lanes (32 / G
    channels of G lanes) each hold a partial sum of 32 positions; after the
    exchanges lane g of channel c holds the sums over the channel's lanes of
    positions g * 32 / G + v in p[v], folded in halves."""
    rng = np.random.RandomState(G)
    p = [list(rng.randn(32).astype(np.float32)) for _ in range(32)]
    orig = [list(v) for v in p]
    w = G // 2
    while w >= 1:
        half = 32 * w // G
        new = [list(v) for v in p]
        for lane in range(32):
            up = bool(lane & w)
            partner = p[lane ^ w]  # not up where this lane is, and the other way round
            for i in range(half):
                received = partner[i + half] if up else partner[i]
                keep = p[lane][i + half] if up else p[lane][i]
                new[lane][i] = np.float32(keep + received)
        p = new
        w //= 2
    v_count = 32 // G
    for lane in range(32):
        c, g = divmod(lane, G)
        for v in range(v_count):
            col = np.array([orig[c * G + m][g * v_count + v] for m in range(G)])
            k = G
            while k > 1:
                k //= 2
                col = (col[:k] + col[k:2 * k]).astype(np.float32)
            assert p[lane][v] == col[0], (lane, v)


@pytest.mark.parametrize("fault", ["float64", "not_contiguous", "three_directions",
                                   "wide_state", "bad_weight", "other_device"])
def test_wrapper_rejects(fault):
    ops = _torch(_operands(1, 16, 6, 3, 2, seed=0))
    err = ValueError
    if fault == "float64":
        ops["xs"], err = ops["xs"].double(), TypeError
    elif fault == "not_contiguous":
        ops["xs"] = ops["xs"].transpose(2, 3)
    elif fault == "three_directions":
        ops["xs"] = ops["xs"][:, :3].contiguous()
    elif fault == "wide_state":
        ops = _torch(_operands(1, 16, 6, 33, 2, seed=0))
    elif fault == "bad_weight":
        ops["dt_w"] = ops["dt_w"][:, :-1].contiguous()
    else:
        ops["A"] = ops["A"].to("meta")
    with pytest.raises(err):
        selective_scan_fused_proj(**ops)


def _fma(a, b, c):
    """fmaf(a, b, c) elementwise on float32 tensors, rounded once: a * b is
    exact in float64, the sum is rounded to odd there (TwoSum's error sets
    the last bit where the float64 sum is inexact), and float64 to float32
    to nearest then rounds the exact value once (53 >= 24 + 2 bits)."""
    a64, p = c.double(), a.double() * b.double()
    s = a64 + p
    bb = s - a64
    e = (a64 - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def fma_chain(a, w):
    """a (..., M, K) . w (..., N, K)^T in float32, each output one FMA chain
    over k in ascending order from zero, as the SIMT GEMM
    (``csrc/simt_gemm.cuh``) takes it."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,), w.shape[:-2] + (1, 1))[:-1]
                      + (w.shape[-2],), dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = _fma(a[..., :, k, None], w[..., None, :, k], acc)
    return acc


def _round_exact(v):
    """The float32 nearest the rational v, ties to even."""
    from fractions import Fraction

    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.array(c, np.float32).view(np.uint32)) & 1))


def test_fma_emulation_rounds_once():
    """``_fma`` against the exact rational a * b + c rounded once, on random
    triples over a wide range of exponents and on a case where rounding to
    float64 first and then to float32 goes wrong: a * b = 2^-24 - 2^-54 on
    c = 1 + 2^-23 lands on a float32 midpoint in float64."""
    from fractions import Fraction

    rng = np.random.RandomState(5)
    n = 4000
    f = lambda e: (rng.randn(n) * 2.0 ** rng.randint(-e, e, n)).astype(np.float32)  # noqa: E731
    a, b, c = f(12), f(12), f(30)
    hard = np.float32([(1 + 2 ** -15) * 2 ** -12, (1 - 2 ** -15) * 2 ** -12, 1 + 2 ** -23])
    a, b, c = (np.append(x, h) for x, h in zip((a, b, c), hard))
    got = _fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_exact(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    twice = np.float32(np.float64(a[-1]) * np.float64(b[-1]) + np.float64(c[-1]))
    assert twice != want[-1]  # the hard case needs the single rounding


def test_fma_chain_is_the_chain():
    """``fma_chain`` is the FMA chain it names, one output at a time, over
    batch and weight broadcasting."""
    rng = np.random.RandomState(6)
    a = torch.from_numpy(rng.randn(2, 3, 5, 37).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 4, 37).astype(np.float32))
    got = fma_chain(a, w[None])
    assert got.shape == (2, 3, 5, 4)
    for i in np.ndindex(2, 3, 5, 4):
        acc = torch.zeros(())
        for k in range(37):
            acc = _fma(a[i[0], i[1], i[2], k], w[i[1], i[3], k], acc)
        assert got[i].item() == acc.item()


def _ulps(x, y):
    """|x - y| in float32 units in the last place (same-sign finite values)."""
    key = lambda t: torch.where(t.view(torch.int32) < 0,  # noqa: E731
                                -(t.view(torch.int32) & 0x7fffffff), t.view(torch.int32))
    return (key(x).long() - key(y).long()).abs()


# MaIRUNet's K3 levels of a 481x321 request (batch 2): level 3 and the latent
K3_LEVELS = [(2, 7872, 384, 16, 12), (2, 1968, 768, 32, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,n,r", K3_LEVELS)
def test_plain_xdbl_is_an_fma_chain_on_card(cuda_device, B, L, d, n, r):
    """The plain version's x_dbl (torch.einsum, on cuBLAS) at K3's shapes is
    bit for bit an ascending FMA chain, the rounding the kernel's GEMM
    takes. K3's scan tolerance against the plain version at these shapes is
    tighter than float32's own error against float64, so the card checks of
    K3 hold only while this does: a library that rounds x_dbl another way
    fails here by name."""
    ops = _torch(_operands(B, L, d, n, r, seed=L + d), cuda_device)
    with torch.inference_mode(), true_float32():
        plain = torch.einsum("bkld,kcd->bklc", ops["xs"], ops["x_proj_w"])
        chain = fma_chain(ops["xs"], ops["x_proj_w"][None])
    ulps = _ulps(plain, chain)
    print(f"L={L} d={d}: {int((ulps > 0).sum())} of {ulps.numel()} x_dbl values differ, "
          f"at most {int(ulps.max())} ulp")
    assert torch.equal(plain, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,n,r", K3_LEVELS + [(1, 95, 130, 32, 24)])  # d % 4: scalar loads
def test_kernel_xdbl_is_an_fma_chain_on_card(cuda_device, B, L, d, n, r):
    """The kernel's own x_dbl, read from its scratch (rows packed as
    ``seq_row_floats`` lays them out), is bit for bit the ascending FMA
    chain."""
    ops = _torch(_operands(B, L, d, n, r, seed=L + d), cuda_device)
    maxn, r4 = _maxn(n), (r + 3) & ~3
    cs = r4 + 2 * maxn
    cs = cs if (cs // 4) % 2 else cs + 4
    lib = _kernels.library()
    y = torch.empty_like(ops["xs"])
    scratch = torch.empty(lib.tpuir_scan_fused_proj_scratch_numel(B, L, d, n, r),
                          device=cuda_device)
    err = lib.tpuir_scan_fused_proj_f32(
        *(ops[k].data_ptr() for k in ("xs", "x_proj_w", "dt_w", "A", "D", "delta_bias")),
        y.data_ptr(), scratch.data_ptr(), B, L, d, n, r,
        torch.cuda.current_stream(cuda_device).cuda_stream)
    _kernels.check(err, "selective_scan_fused_proj")
    rows = scratch[:B * 4 * L * cs].view(B, 4, L, cs)
    got = torch.cat([rows[..., :r], rows[..., r4:r4 + n], rows[..., r4 + maxn:r4 + maxn + n]], -1)
    with torch.inference_mode():
        chain = fma_chain(ops["xs"], ops["x_proj_w"][None])
    assert torch.equal(got, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,n,r", [
    (1, 64, 24, 4, 2), (2, 100, 12, 5, 2), (2, 600, 40, 16, 3),
    (2, 7872, 384, 16, 12),   # MaIRUNet level 3 of a 481x321 request (96x82 tiles)
    (2, 1968, 768, 32, 24),   # its latent level (48x41 tiles)
    (1, 257, 300, 32, 64),    # ragged chunk, three channel blocks, over 48 KB of shared memory
])
def test_kernel_matches_plain_on_card(cuda_device, B, L, d, n, r):
    ops = _torch(_operands(B, L, d, n, r, seed=L + d), cuda_device)
    before = _kernels.LAUNCHES["selective_scan_fused_proj"]
    with torch.inference_mode(), true_float32():
        y = selective_scan_fused_proj(**ops)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["selective_scan_fused_proj"] == before + 1
        again = selective_scan_fused_proj(**ops)
        want = selective_scan_fused_proj_plain(**ops)
    assert torch.equal(y, again)  # no atomics
    torch.testing.assert_close(y, want, atol=SCAN_ATOL, rtol=SCAN_RTOL)


# (B, L, d, n, r): each ceiling and so each lane layout (SEQ_LANES), d not a
# multiple of the block's channels, L under, at, just past and well past a
# 32-position tile and not a multiple of 32, R not a multiple of 4
SWEEP = [
    (1, 31, 100, 4, 3), (2, 32, 72, 7, 5), (1, 33, 50, 16, 12), (2, 95, 130, 32, 24),
    (1, 1000, 200, 3, 2), (2, 517, 96, 12, 6), (1, 64, 777, 32, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,n,r", SWEEP)
def test_one_pass_kernel_sweep_on_card(cuda_device, B, L, d, n, r):
    ops = _torch(_operands(B, L, d, n, r, seed=L + 7 * d), cuda_device)
    before = _kernels.LAUNCHES["selective_scan_fused_proj"]
    with torch.inference_mode(), true_float32():
        y = selective_scan_fused_proj(**ops)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["selective_scan_fused_proj"] == before + 1
        again = selective_scan_fused_proj(**ops)
        want = selective_scan_fused_proj_plain(**ops)
    assert torch.equal(y, again)  # no atomics
    torch.testing.assert_close(y, want, atol=SCAN_ATOL, rtol=SCAN_RTOL)
