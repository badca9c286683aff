"""The MaIR mixer's kernels in the port (K6 prologue, K2 NSS scan, K7
epilogue): their plain versions against the JAX kernels in interpret mode
and against the JAX references on the CPU, the plain scan and the scan ids
against ``tpuir``'s, the wrappers' checks, and the CUDA kernels against the
plain versions on a card.

Inputs come from NumPy seeds. JAX is imported only on the reference side,
so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_epilogue import mixer_epilogue, mixer_epilogue_plain, padded_inner
from tpuir_torch.ops.nss_prologue import mixer_prologue, mixer_prologue_plain
from tpuir_torch.ops.nss_stripe import nss_scan, nss_scan_plain
from tpuir_torch.ops.scan_ids import mair_scan_ids
from tpuir_torch.ops.selective_scan import selective_scan

# the JAX package's tolerance for its scan against the reference
# (tests/test_mair.py:47): float32 sums in another order
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _prologue_operands(B, H, W, dm, di, seed):
    """NHWC h and torch-layout weights (w_in (2di, dm), conv (di, 1, 3, 3), bias)."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(B, H, W, dm) * 0.5).astype(np.float32)
    w_in = (rng.randn(2 * di, dm) / np.sqrt(dm)).astype(np.float32)
    conv_w = (rng.randn(di, 1, 3, 3) * 0.3).astype(np.float32)
    conv_b = (rng.randn(di) * 0.05).astype(np.float32)
    return h, w_in, conv_w, conv_b


def _scan_operands(B, H, W, d, n, r, seed):
    """x and the scan weights as the port takes them (A already -exp), the
    projections scaled by their fan-in so that x_dbl and dt stay unit-scale
    at any width."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(B, H, W, d), x_proj_w=f(4, r + 2 * n, d) / np.float32(np.sqrt(d)),
        dt_w=f(4, d, r) / np.float32(np.sqrt(r)),
        A=-np.exp(f(4, d, n) * np.float32(0.3)).astype(np.float32),
        D=f(4, d) * np.float32(0.3), delta_bias=f(4, d) * np.float32(0.3),
    )


def _assert_pooled_close(got, want, y):
    """pooled is a sum over the path of values the two versions round
    differently: the bound scales with the sum of |y|, not with the sum."""
    err = (got - want).abs()
    assert bool((err <= SCAN_ATOL + SCAN_RTOL * y.abs().sum((2, 3))).all()), err.max()


def _epilogue_operands(B, H, W, di, dm, seed):
    rng = np.random.RandomState(seed)
    return dict(
        y=(rng.randn(B, 4, H, W, di) * 0.5).astype(np.float32),
        gates=rng.rand(B, 4, di).astype(np.float32),
        z=(rng.randn(B, H, W, di) * 0.5).astype(np.float32),
        ln_w=(rng.randn(di) * 0.2 + 1.0).astype(np.float32),
        ln_b=(rng.randn(di) * 0.1).astype(np.float32),
        w_out=(rng.randn(dm, di) / np.sqrt(di)).astype(np.float32),
    )


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


# --- the scan ids and the plain scan ---------------------------------------


@pytest.mark.parametrize("H,W", [(16, 16), (8, 12), (128, 128), (96, 72)])
@pytest.mark.parametrize("shift_len", [0, 2])
def test_scan_ids_equal(H, W, shift_len):
    from tpuir.ops.scan_ids import mair_scan_ids as jids

    for got, want in zip(mair_scan_ids(H, W, 4, shift_len), jids(H, W, 4, shift_len)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("L,chunk", [(64, 16), (50, 16), (40, 64)])
def test_selective_scan_matches_jax(L, chunk):
    import jax.numpy as jnp

    from tpuir.ops.selective_scan import selective_scan as jscan

    rng = np.random.RandomState(L)
    B, K, d, n = 2, 4, 6, 3
    u = rng.randn(B, K, L, d).astype(np.float32)
    delta = (rng.randn(B, K, L, d) * 0.5).astype(np.float32)
    A = -np.exp(rng.randn(K, d, n) * 0.3).astype(np.float32)
    Bm, Cm = rng.randn(2, B, K, L, n).astype(np.float32)
    D, bias = (rng.randn(2, K, d) * 0.3).astype(np.float32)
    want = np.asarray(jscan(*map(jnp.asarray, (u, delta, A, Bm, Cm, D, bias)),
                            delta_softplus=True, chunk=chunk))
    got = selective_scan(*map(torch.from_numpy, (u, delta, A, Bm, Cm, D, bias)),
                         delta_softplus=True, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=SCAN_ATOL, rtol=SCAN_RTOL)


# --- K6: the prologue -----------------------------------------------------


@pytest.mark.parametrize("B,H,W,dm,di", [(1, 16, 16, 20, 28), (2, 24, 16, 12, 12),
                                         (1, 8, 8, 180, 234)])
def test_prologue_plain_matches_jax_kernel(B, H, W, dm, di):
    import jax.numpy as jnp

    from tpuir.ops import nss_prologue as jpro

    h, w_in, conv_w, conv_b = _prologue_operands(B, H, W, dm, di, seed=H + dm)
    # the JAX kernel's layouts: w_in (dm, 2di), HWIO depthwise kernel
    jargs = (jnp.asarray(h), jnp.asarray(w_in.T), jnp.asarray(conv_w.transpose(2, 3, 1, 0)),
             jnp.asarray(conv_b))
    xp, _, zp = jpro.mixer_prologue(*jargs, di, interpret=True)
    rx, _, rz = jpro._reference(*jargs, di)
    before = dict(_kernels.LAUNCHES)
    x, z = mixer_prologue(*map(torch.from_numpy, (h, w_in, conv_w, conv_b)))
    assert _kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert x.shape == z.shape == (B, H, W, di) and x.is_contiguous() and z.is_contiguous()
    for got, kern, ref in ((x, xp, rx), (z, zp, rz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(kern)[..., :di], atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref)[..., :di], atol=1e-5)


# --- K2: the NSS scan ------------------------------------------------------


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("H,W", [(8, 8), (16, 16), (8, 12), (12, 8)])
def test_scan_plain_matches_jax_reference_and_kernel(shift, H, W):
    import jax.numpy as jnp

    from tpuir.ops import nss_stripe as js

    B, d, n, r = 2, 6, 3, 2
    ops = _scan_operands(B, H, W, d, n, r, seed=H * W + shift)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    y_ref, pool_ref = js._reference(j["x"], j["x_proj_w"], j["dt_w"], j["A"], j["D"],
                                    j["delta_bias"], 4, shift)
    before = dict(_kernels.LAUNCHES)
    y, pooled = nss_scan(**_torch(ops), scan_len=4, shift=shift)
    assert _kernels.LAUNCHES == before
    assert y.shape == (B, 4, H, W, d) and pooled.shape == (B, 4, d)
    y, pooled = y.numpy(), pooled.numpy()
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=SCAN_ATOL, rtol=SCAN_RTOL)
    np.testing.assert_allclose(pooled, np.asarray(pool_ref), atol=SCAN_ATOL, rtol=SCAN_RTOL)

    # the Pallas kernel (the prologue's pre-padded operands), one direction
    # at a time out of its half buffers through a one-hot gate
    xp = jnp.pad(j["x"], ((0, 0), (0, 0), (0, 0), (0, (-d) % 128)))
    out = js.nss_scan_stripe_pre(xp, jnp.transpose(xp, (0, 2, 1, 3)), j["x_proj_w"], j["dt_w"],
                                 j["A"], j["D"], j["delta_bias"], scan_len=4, shift=shift,
                                 vert_p=4, interpret=True)
    np.testing.assert_allclose(pooled, np.asarray(out[4]), atol=SCAN_ATOL, rtol=SCAN_RTOL)
    for k in range(4):
        g = jnp.zeros((B, 4, d)).at[:, k].set(1.0)
        y_k = js.combine_halves(*out[:4], g, shift, 4)
        np.testing.assert_allclose(y[:, k], np.asarray(y_k), atol=SCAN_ATOL, rtol=SCAN_RTOL,
                                   err_msg=f"direction {k}")


@pytest.mark.parametrize("n", [4, 8, 32])
def test_scan_plain_state_widths_match_jax(n):
    """MaIRUNet's d_state per level (4, 8, 16, 32): the plain scan against
    the JAX reference and the Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from tpuir.ops import nss_stripe as js

    B, H, W, d, r = 1, 8, 12, 10, 2
    ops = _scan_operands(B, H, W, d, n, r, seed=n)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    y_ref, pool_ref = js._reference(j["x"], j["x_proj_w"], j["dt_w"], j["A"], j["D"],
                                    j["delta_bias"], 4, False)
    y, pooled = nss_scan(**_torch(ops), scan_len=4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=SCAN_ATOL, rtol=SCAN_RTOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pool_ref), atol=SCAN_ATOL,
                               rtol=SCAN_RTOL)
    xp = jnp.pad(j["x"], ((0, 0), (0, 0), (0, 0), (0, (-d) % 128)))
    out = js.nss_scan_stripe_pre(xp, jnp.transpose(xp, (0, 2, 1, 3)), j["x_proj_w"], j["dt_w"],
                                 j["A"], j["D"], j["delta_bias"], scan_len=4, shift=False,
                                 vert_p=4, interpret=True)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(out[4]), atol=SCAN_ATOL,
                               rtol=SCAN_RTOL)


def test_scan_plain_full_width_matches_jax_reference():
    """MaIR-CDN's widths (d_inner 234, d_state 16, dt rank 12) on a small tile."""
    import jax.numpy as jnp

    from tpuir.ops import nss_stripe as js

    ops = _scan_operands(1, 16, 8, 234, 16, 12, seed=5)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    for shift in (False, True):
        y_ref, pool_ref = js._reference(j["x"], j["x_proj_w"], j["dt_w"], j["A"], j["D"],
                                        j["delta_bias"], 4, shift)
        y, pooled = nss_scan(**_torch(ops), scan_len=4, shift=shift)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=SCAN_ATOL, rtol=SCAN_RTOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(pool_ref), atol=SCAN_ATOL,
                                   rtol=SCAN_RTOL)


# --- K7: the epilogue ------------------------------------------------------


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,di,dm", [(1, 8, 8, 12, 10), (2, 8, 12, 28, 20),
                                         (1, 8, 8, 234, 180)])
def test_epilogue_plain_matches_jax_kernel(shift, B, H, W, di, dm):
    import jax.numpy as jnp

    from tpuir.ops import nss_epilogue as je

    ops = _epilogue_operands(B, H, W, di, dm, seed=di + W)
    dp = (-di) % 128
    pad = lambda a: jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, dp)])  # noqa: E731
    y = ops["y"]
    # equal L and R buffers, so that the kernel's half-select cannot matter:
    # directions 0/1 in the x^T frame, 2/3 in the image frame
    y01 = pad(np.ascontiguousarray(y[:, :2].transpose(0, 1, 3, 2, 4)))
    y23 = pad(y[:, 2:])
    jargs = (y01, y01, y23, y23, jnp.asarray(ops["gates"]), pad(ops["z"]),
             jnp.asarray(ops["ln_w"]), jnp.asarray(ops["ln_b"]), jnp.asarray(ops["w_out"].T))
    want = np.asarray(je.mixer_epilogue(*jargs, di, shift=shift, scan_len=4, interpret=True))
    before = dict(_kernels.LAUNCHES)
    got = mixer_epilogue(**_torch(ops))
    assert _kernels.LAUNCHES == before
    assert got.shape == (B, H, W, dm)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("di,dp", [(1, 4), (12, 12), (33, 36), (96, 96), (192, 192),
                                   (234, 236), (300, 300), (383, 384), (768, 768), (1021, 1024)])
def test_epilogue_padded_inner(di, dp):
    """K7's gated rows and its padded out_proj weight are d_inner floats
    rounded up to a multiple of 4, so that the GEMM core copies them 16
    bytes at a time; MaIRUNet's widths (96 to 768) need no padding,
    MaIR-CDN's 234 two floats."""
    assert padded_inner(di) == dp


# --- the wrappers' checks --------------------------------------------------


@pytest.mark.parametrize("fault", ["float64", "not_contiguous", "bad_weight", "odd_width",
                                   "wide_state", "wide_inner"])
def test_wrappers_reject(fault):
    pro = [torch.from_numpy(a) for a in _prologue_operands(1, 8, 8, 6, 8, seed=0)]
    scan = _torch(_scan_operands(1, 8, 8, 6, 3, 2, seed=0))
    epi = _torch(_epilogue_operands(1, 8, 8, 6, 4, seed=0))
    if fault == "float64":
        call, err = lambda: mixer_prologue(pro[0].double(), *pro[1:]), TypeError
    elif fault == "not_contiguous":
        scan["x"] = scan["x"].transpose(1, 2)
        call, err = lambda: nss_scan(**scan), ValueError
    elif fault == "bad_weight":
        epi["w_out"] = epi["w_out"][:, :-1].contiguous()
        call, err = lambda: mixer_epilogue(**epi), ValueError
    elif fault == "odd_width":  # W not a multiple of scan_len: the K3 path
        scan["x"] = scan["x"][:, :, :6].contiguous()
        call, err = lambda: nss_scan(**scan), ValueError
    elif fault == "wide_state":
        ops = _torch(_scan_operands(1, 8, 8, 6, 33, 2, seed=0))
        call, err = lambda: nss_scan(**ops), ValueError
    else:
        ops = _torch(_epilogue_operands(1, 4, 4, 1025, 4, seed=0))
        call, err = lambda: mixer_epilogue(**ops), ValueError
    with pytest.raises(err):
        call()


# --- the CUDA kernels against their plain versions, on a card -------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,dm,di", [(2, 16, 16, 20, 28), (2, 24, 16, 12, 12),
                                         (2, 32, 24, 180, 234), (1, 9, 13, 33, 65)])
def test_prologue_kernel_matches_plain_on_card(cuda_device, B, H, W, dm, di):
    ops = [torch.from_numpy(a).to(cuda_device)
           for a in _prologue_operands(B, H, W, dm, di, seed=di)]
    before = _kernels.LAUNCHES["mixer_prologue"]
    with torch.inference_mode(), true_float32():
        x, z = mixer_prologue(*ops)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["mixer_prologue"] == before + 1
        rx, rz = mixer_prologue_plain(*ops)
    # float32 sums in another order than cuBLAS/cuDNN: unit-scale inputs
    torch.testing.assert_close(x, rx, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(z, rz, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,dm,di", [(2, 32, 24, 180, 234), (1, 9, 13, 33, 65),
                                         (2, 16, 16, 96, 192)])
def test_prologue_kernel_repeats_bit_for_bit_on_card(cuda_device, B, H, W, dm, di):
    """in_proj on the tensor cores (3xTF32, one sum order) and the conv
    repeat bit for bit; dm 33 takes the core's 4-byte copies, di 65 its
    one-float split store."""
    ops = [torch.from_numpy(a).to(cuda_device)
           for a in _prologue_operands(B, H, W, dm, di, seed=dm)]
    with torch.inference_mode():
        x, z = mixer_prologue(*ops)
        x2, z2 = mixer_prologue(*ops)
    assert torch.equal(x, x2) and torch.equal(z, z2)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,d,n,r", [(2, 8, 8, 6, 3, 2), (2, 16, 24, 40, 16, 3),
                                         (2, 32, 32, 234, 16, 12), (1, 96, 72, 234, 16, 12),
                                         (2, 32, 24, 96, 4, 3), (2, 16, 16, 192, 8, 6),
                                         (2, 24, 16, 768, 32, 24), (1, 8, 12, 40, 32, 64),
                                         (2, 16, 20, 100, 16, 7)])
def test_scan_kernel_matches_plain_on_card(cuda_device, shift, B, H, W, d, n, r):
    ops = _torch(_scan_operands(B, H, W, d, n, r, seed=H + W), cuda_device)
    before = _kernels.LAUNCHES["nss_scan"]
    with torch.inference_mode(), true_float32():
        y, pooled = nss_scan(**ops, scan_len=4, shift=shift)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["nss_scan"] == before + 1
        again = nss_scan(**ops, scan_len=4, shift=shift)
        ry, rpooled = nss_scan_plain(**ops, scan_len=4, shift=shift)
    assert torch.equal(y, again[0]) and torch.equal(pooled, again[1])  # no atomics
    torch.testing.assert_close(y, ry, atol=SCAN_ATOL, rtol=SCAN_RTOL)
    _assert_pooled_close(pooled, rpooled, ry)


def _extreme_scan_operands(B, H, W, d, n, r, seed):
    """_scan_operands with every other state's |A| near e^4.5 (so that
    exp(dt * A) underflows for dt above about 1) and the softplus arguments
    spread over -20..20 by the channels' bias."""
    ops = _scan_operands(B, H, W, d, n, r, seed)
    ops["A"] = (ops["A"] * np.exp(4.5 * (np.arange(n) % 2))).astype(np.float32)
    ops["delta_bias"] = np.tile(np.linspace(-20, 20, d, dtype=np.float32), (4, 1))
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,d,n,r", [(2, 16, 24, 100, 16, 7), (1, 32, 32, 234, 16, 12)])
def test_scan_kernel_extreme_arguments_on_card(cuda_device, shift, B, H, W, d, n, r):
    """The kernel's MUFU exp2 and two-MUFU softplus where dt * A underflows
    and the softplus arguments reach both of its tails."""
    ops = _torch(_extreme_scan_operands(B, H, W, d, n, r, seed=d), cuda_device)
    with torch.inference_mode(), true_float32():
        y, pooled = nss_scan(**ops, scan_len=4, shift=shift)
        again = nss_scan(**ops, scan_len=4, shift=shift)
        ry, rpooled = nss_scan_plain(**ops, scan_len=4, shift=shift)
    assert torch.equal(y, again[0]) and torch.equal(pooled, again[1])
    torch.testing.assert_close(y, ry, atol=SCAN_ATOL, rtol=SCAN_RTOL)
    _assert_pooled_close(pooled, rpooled, ry)


# K7's real widths (MaIR-CDN: Di 234, Dm 180, a row that is not a multiple
# of 4 floats; MaIRUNet's levels: Di 96-768), each at a pixel count that is
# not a multiple of any row tile and, at B 2, with images that share a tile
K7_WIDTHS = [(1, 5, 13, 96, 48), (2, 7, 9, 192, 96), (1, 11, 13, 234, 180),
             (2, 5, 7, 384, 192), (1, 9, 7, 768, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,di,dm", [(2, 8, 8, 12, 10), (2, 16, 24, 234, 180),
                                         (1, 5, 7, 300, 33), (1, 4, 4, 1024, 64)] + K7_WIDTHS)
def test_epilogue_kernel_matches_plain_on_card(cuda_device, B, H, W, di, dm):
    ops = _torch(_epilogue_operands(B, H, W, di, dm, seed=di), cuda_device)
    before = _kernels.LAUNCHES["mixer_epilogue"]
    with torch.inference_mode(), true_float32():
        got = mixer_epilogue(**ops)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["mixer_epilogue"] == before + 1
        want = mixer_epilogue_plain(**ops)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,di,dm", K7_WIDTHS)
def test_epilogue_kernel_within_float64_on_card(cuda_device, B, H, W, di, dm):
    """out_proj in 3xTF32 keeps float32 parity: held to the plain version
    in float64, not only to the float32 one."""
    ops = _torch(_epilogue_operands(B, H, W, di, dm, seed=dm), cuda_device)
    with torch.inference_mode():
        got = mixer_epilogue(**ops).double()
        want = mixer_epilogue_plain(**{k: v.double() for k, v in ops.items()})
    assert bool(((got - want).abs() <= 5e-5 + 1e-4 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,di,dm", K7_WIDTHS)
def test_epilogue_kernel_repeats_bit_for_bit_on_card(cuda_device, B, H, W, di, dm):
    ops = _torch(_epilogue_operands(B, H, W, di, dm, seed=di + 1), cuda_device)
    with torch.inference_mode():
        first = mixer_epilogue(**ops)
        again = mixer_epilogue(**ops)
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,di,dm", [(2, 7, 9, 192, 96), (1, 11, 13, 234, 180)])
def test_epilogue_kernel_nan_spoils_its_row_only_on_card(cuda_device, B, H, W, di, dm):
    """A NaN in one direction of one pixel's y row makes that pixel's output
    row NaN (its LayerNorm statistics are NaN) and leaves every other row as
    the plain version gives it: the rows that share its tile stay clean."""
    ops = _epilogue_operands(B, H, W, di, dm, seed=3)
    b, h, w = B - 1, H // 2, W // 2
    ops["y"][b, 2, h, w, di // 3] = np.nan
    ops = _torch(ops, cuda_device)
    with torch.inference_mode(), true_float32():
        got = mixer_epilogue(**ops)
        want = mixer_epilogue_plain(**ops)
    assert bool(torch.isnan(got[b, h, w]).all())
    keep = torch.ones(B, H, W, dtype=torch.bool, device=cuda_device)
    keep[b, h, w] = False
    assert bool(torch.isfinite(got[keep]).all())
    torch.testing.assert_close(got[keep], want[keep], atol=2e-5, rtol=1e-4)
