"""The serving bodies of the MaIR mixer's kernels in the port (K6 prologue,
K2 NSS scan, K7 epilogue): their plain versions against tpuir's kernels with
``serving=True`` in interpret mode on the same inputs, the wrappers' dtype
checks, the stage checks of ``utils/serving_check.py`` against the plain
versions and planted faults on the CPU, and the CUDA kernels against the
stage checks on a card.

The tolerances are tpuir's own for a serving body: every bf16 output within
two bf16 ulps, 2^-6 max(|ref|, 1), of tpuir's; the mean difference within
1/20 of the mean gap between tpuir's serving and parity outputs on the same
inputs; pooled within the parity scan tolerance 5e-5 + 1e-3 sum|y|. Inputs
come from NumPy seeds; JAX is imported only on the reference side, so the
card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_epilogue import (epilogue_serving_values, gated_rows_serving,
                                          mixer_epilogue, mixer_epilogue_serving_plain,
                                          mixer_epilogue_serving_stages, padded_inner)
from tpuir_torch.ops.nss_prologue import (mixer_prologue, mixer_prologue_serving_plain,
                                          mixer_prologue_serving_stages, prologue_serving_values)
from tpuir_torch.ops.nss_stripe import (nss_scan, nss_scan_serving_plain,
                                        nss_scan_serving_stages, scan_from_xdbl,
                                        scan_serving_values)
from tpuir_torch.utils import serving_mutants
from tpuir_torch.utils.serving_check import (check_epilogue_serving, check_prologue_serving,
                                             check_scan_serving)
from tests.torch_threads import one_torch_thread  # noqa: F401

SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # tests/test_torch_nss.py's parity scan tolerance
GAP_SHARE = 1 / 20  # the mean difference, as a share of the serving-parity gap


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 a rounded to bf16 (nearest even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _prologue_operands(B, H, W, dm, di, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(B, H, W, dm) * 0.5).astype(np.float32),
            (rng.randn(2 * di, dm) / np.sqrt(dm)).astype(np.float32),
            (rng.randn(di, 1, 3, 3) * 0.3).astype(np.float32),
            (rng.randn(di) * 0.05).astype(np.float32))


def _scan_operands(B, H, W, d, n, r, seed):
    """x (bf16 values, as float32) and the scan weights as the port takes
    them, the projections scaled by their fan-in."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=_bf16(f(B, H, W, d)), x_proj_w=f(4, r + 2 * n, d) / np.float32(np.sqrt(d)),
        dt_w=f(4, d, r) / np.float32(np.sqrt(r)),
        A=-np.exp(f(4, d, n) * np.float32(0.3)).astype(np.float32),
        D=f(4, d) * np.float32(0.3), delta_bias=f(4, d) * np.float32(0.3),
    )


def _epilogue_operands(B, H, W, di, dm, seed):
    """y and z as bf16 values (float32), the rest float32."""
    rng = np.random.RandomState(seed)
    return dict(
        y=_bf16(rng.randn(B, 4, H, W, di) * 0.5), gates=rng.rand(B, 4, di).astype(np.float32),
        z=_bf16(rng.randn(B, H, W, di) * 0.5),
        ln_w=(rng.randn(di) * 0.2 + 1.0).astype(np.float32),
        ln_b=(rng.randn(di) * 0.1).astype(np.float32),
        w_out=(rng.randn(dm, di) / np.sqrt(di)).astype(np.float32),
    )


def _torch(d, device="cpu", bf16=()):
    """NumPy operands as tensors; the names in ``bf16`` as bf16 tensors."""
    return {k: torch.from_numpy(v).to(device).to(torch.bfloat16 if k in bf16 else torch.float32)
            for k, v in d.items()}


def _assert_serving_close(got, want, parity, what):
    """tpuir's criteria for a serving body: every element within two bf16
    ulps of tpuir's serving output, the mean difference within GAP_SHARE of
    the mean |tpuir serving - tpuir parity|."""
    got, want, parity = (np.asarray(a, np.float64) for a in (got, want, parity))
    err = np.abs(got - want)
    assert (err <= 2.0 ** -6 * np.maximum(np.abs(want), 1.0)).all(), (what, err.max())
    gap = np.abs(want - parity).mean()
    assert gap > 0, what
    assert err.mean() <= GAP_SHARE * gap, (what, err.mean(), gap)


def _unchanged(fn):
    """fn() with the launch counts checked unchanged (a CPU tensor takes the
    plain version)."""
    before = dict(_kernels.LAUNCHES)
    out = fn()
    assert _kernels.LAUNCHES == before
    return out


# --- the plain serving versions against tpuir's serving kernels -------------


@pytest.mark.parametrize("B,H,W,dm,di", [(1, 16, 16, 20, 28), (1, 8, 8, 180, 234)])
def test_prologue_serving_plain_matches_jax_kernel(B, H, W, dm, di):
    import jax.numpy as jnp

    from tpuir.ops import nss_prologue as jpro

    h, w_in, conv_w, conv_b = _prologue_operands(B, H, W, dm, di, seed=H + dm)
    jargs = (jnp.asarray(h), jnp.asarray(w_in.T), jnp.asarray(conv_w.transpose(2, 3, 1, 0)),
             jnp.asarray(conv_b))
    xs, _, zs = jpro.mixer_prologue(*jargs, di, serving=True, interpret=True)
    xp, _, zp = jpro.mixer_prologue(*jargs, di, interpret=True)
    x, z = _unchanged(lambda: mixer_prologue(*map(torch.from_numpy, (h, w_in, conv_w, conv_b)),
                                             serving=True))
    assert x.dtype == z.dtype == torch.bfloat16 and x.shape == z.shape == (B, H, W, di)
    assert str(xs.dtype) == "bfloat16"
    for name, got, serving, parity in (("x", x, xs, xp), ("z", z, zs, zp)):
        _assert_serving_close(got.float().numpy(), np.asarray(serving, np.float32)[..., :di],
                              np.asarray(parity)[..., :di], name)


@pytest.mark.parametrize("H,W,n,shift", [(8, 8, 3, False), (8, 8, 3, True), (8, 12, 3, False),
                                         (8, 12, 3, True), (16, 16, 8, False)])
def test_scan_serving_plain_matches_jax_kernel(H, W, n, shift):
    """tpuir's stripe kernel with serving=True on the prologue's bf16
    operands, square (K2b) and rectangular (K2a), one direction at a time
    out of its half buffers through a one-hot gate."""
    import jax.numpy as jnp

    from tpuir.ops import nss_stripe as js

    B, d, r = 2, 6, 2
    ops = _scan_operands(B, H, W, d, n, r, seed=H * W + n + shift)
    j = {k: jnp.asarray(v) for k, v in ops.items()}

    def tpuir_scan(serving):
        xp = jnp.pad(j["x"], ((0, 0), (0, 0), (0, 0), (0, (-d) % 128)))
        if serving:
            xp = xp.astype(jnp.bfloat16)
        out = js.nss_scan_stripe_pre(xp, jnp.transpose(xp, (0, 2, 1, 3)), j["x_proj_w"],
                                     j["dt_w"], j["A"], j["D"], j["delta_bias"], scan_len=4,
                                     shift=shift, serving=serving, vert_p=4, interpret=True)
        ys = [js.combine_halves(*out[:4], jnp.zeros((B, 4, d)).at[:, k].set(1.0), shift, 4)
              for k in range(4)]
        return np.stack([np.asarray(y, np.float32) for y in ys], 1), np.asarray(out[4])

    (ys, pool_s), (yp, _) = tpuir_scan(True), tpuir_scan(False)
    y, pooled = _unchanged(lambda: nss_scan(**_torch(ops, bf16=("x",)), scan_len=4, shift=shift,
                                            serving=True))
    assert y.dtype == torch.bfloat16 and pooled.dtype == torch.float32
    assert y.shape == (B, 4, H, W, d) and pooled.shape == (B, 4, d)
    _assert_serving_close(y.float().numpy(), ys, yp, "y")
    err = np.abs(pooled.numpy() - pool_s)
    assert (err <= SCAN_ATOL + SCAN_RTOL * np.abs(ys).sum((2, 3))).all(), err.max()


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,di,dm", [(1, 8, 8, 12, 10), (1, 8, 8, 234, 180)])
def test_epilogue_serving_plain_matches_jax_kernel(shift, B, H, W, di, dm):
    import jax.numpy as jnp

    from tpuir.ops import nss_epilogue as je

    ops = _epilogue_operands(B, H, W, di, dm, seed=di + W + shift)
    dp = (-di) % 128
    pad = lambda a: jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, dp)])  # noqa: E731
    y = ops["y"]
    # equal L and R buffers, so that the kernel's half-select cannot matter
    y01 = pad(np.ascontiguousarray(y[:, :2].transpose(0, 1, 3, 2, 4)))
    y23 = pad(y[:, 2:])

    def tpuir_epilogue(serving):
        io = (lambda a: a.astype(jnp.bfloat16)) if serving else (lambda a: a)
        return np.asarray(je.mixer_epilogue(
            io(y01), io(y01), io(y23), io(y23), jnp.asarray(ops["gates"]), io(pad(ops["z"])),
            jnp.asarray(ops["ln_w"]), jnp.asarray(ops["ln_b"]), jnp.asarray(ops["w_out"].T), di,
            shift=shift, scan_len=4, serving=serving, interpret=True))

    got = _unchanged(lambda: mixer_epilogue(**_torch(ops, bf16=("y", "z")), serving=True))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, dm)
    _assert_serving_close(got.numpy(), tpuir_epilogue(True), tpuir_epilogue(False), "out")


# --- the wrappers' dtype checks --------------------------------------------


@pytest.mark.parametrize("case", ["prologue_bf16_h", "scan_f32_x_serving", "scan_bf16_x_parity",
                                  "epilogue_f32_serving", "epilogue_bf16_parity",
                                  "epilogue_mixed_serving"])
def test_serving_wrappers_reject_the_other_modes_dtypes(case):
    h, w_in, conv_w, conv_b = map(torch.from_numpy, _prologue_operands(1, 8, 8, 6, 8, seed=0))
    scan = _torch(_scan_operands(1, 8, 8, 6, 3, 2, seed=0))
    epi = _torch(_epilogue_operands(1, 8, 8, 6, 4, seed=0))
    bf = lambda d, *names: {k: v.to(torch.bfloat16) if k in names else v  # noqa: E731
                            for k, v in d.items()}
    calls = {
        "prologue_bf16_h": lambda: mixer_prologue(h.to(torch.bfloat16), w_in, conv_w, conv_b,
                                                  serving=True),
        "scan_f32_x_serving": lambda: nss_scan(**scan, serving=True),
        "scan_bf16_x_parity": lambda: nss_scan(**bf(scan, "x")),
        "epilogue_f32_serving": lambda: mixer_epilogue(**epi, serving=True),
        "epilogue_bf16_parity": lambda: mixer_epilogue(**bf(epi, "y", "z")),
        "epilogue_mixed_serving": lambda: mixer_epilogue(**bf(epi, "y"), serving=True),
    }
    with pytest.raises(TypeError):
        calls[case]()


def test_serving_stage_entries_are_the_plain_versions_on_cpu():
    """On a CPU tensor each stage entry returns the plain version's stages,
    whose outputs are the plain version's, and launches nothing."""
    h, w_in, conv_w, conv_b = map(torch.from_numpy, _prologue_operands(1, 8, 12, 10, 12, seed=1))
    st = _unchanged(lambda: mixer_prologue_serving_stages(h, w_in, conv_w, conv_b))
    x, z = mixer_prologue_serving_plain(h, w_in, conv_w, conv_b)
    assert torch.equal(st["x"], x) and torch.equal(st["z"], z) and st["xpre"].shape == x.shape
    scan = _torch(_scan_operands(1, 8, 12, 12, 3, 2, seed=1), bf16=("x",))
    st = _unchanged(lambda: nss_scan_serving_stages(**scan, shift=True))
    y, pooled = nss_scan_serving_plain(**scan, shift=True)
    assert torch.equal(st["y"], y) and torch.equal(st["pooled"], pooled)
    assert st["x_dbl"].shape == (1, 96, 4, 2 + 2 * 3)
    epi = _torch(_epilogue_operands(1, 8, 12, 12, 10, seed=1), bf16=("y", "z"))
    st = _unchanged(lambda: mixer_epilogue_serving_stages(**epi))
    assert torch.equal(st["out"], mixer_epilogue_serving_plain(**epi))
    assert st["gated"].shape == (1, 8, 12, padded_inner(12))


# --- the stage checks: the plain versions pass, planted faults do not -------


def _planted_prologue(fault, h, w_in, conv_w, conv_b):
    """The plain serving stages of K6, with one fault planted."""
    st = prologue_serving_values(h, w_in, conv_w, conv_b)
    if fault == "none":
        return st
    di = conv_w.shape[0]
    a = h if fault == "h unrounded" else h.to(torch.bfloat16).float()
    w = w_in if fault == "W_in unrounded" else w_in.to(torch.bfloat16).float()
    xz = F.linear(a, w)
    xpre = xz[..., :di].contiguous()
    x = F.silu(F.conv2d(xpre.permute(0, 3, 1, 2), conv_w, conv_b, padding=1, groups=di))
    return {"xpre": xpre, "x": x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(),
            "z": xz[..., di:].to(torch.bfloat16).contiguous()}


def _truncate_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 t cut to bf16 toward zero (its low 16 bits dropped)."""
    return (t.float().contiguous().view(torch.int32) & -65536).view(torch.float32).to(
        torch.bfloat16)


def _planted_scan(fault, ops, shift):
    """The plain serving stages of K2, with one fault planted."""
    if fault == "none":
        return scan_serving_values(**ops, scan_len=4, shift=shift)
    x = ops["x"]
    B, H, W, d = x.shape
    xw = x.reshape(B, H * W, d).float()
    wxp = ops["x_proj_w"] if fault == "W_xp unrounded" else ops["x_proj_w"].to(
        torch.bfloat16).float()
    xdbl = torch.einsum("bld,kcd->blkc", xw, wxp).contiguous()
    y, pooled = scan_from_xdbl(xw, xdbl, ops["dt_w"], ops["A"], ops["D"], ops["delta_bias"], H,
                               W, 4, shift)
    y16 = _truncate_bf16(y) if fault == "y truncated" else y.to(torch.bfloat16)
    return {"x_dbl": xdbl, "y": y16, "pooled": pooled}


def _planted_epilogue(fault, ops):
    """The plain serving stages of K7, with one fault planted."""
    st = epilogue_serving_values(**ops)
    if fault == "none":
        return st
    di = ops["y"].shape[-1]
    g = gated_rows_serving(ops["y"], ops["gates"], ops["z"], ops["ln_w"], ops["ln_b"])
    a = g if fault == "gated rows unrounded" else g.to(torch.bfloat16).float()
    w = ops["w_out"] if fault == "W_out unrounded" else ops["w_out"].to(torch.bfloat16).float()
    return {"gated": st["gated"], "out": F.linear(a[..., :di], w)}


@pytest.mark.parametrize("fault", ["none", "h unrounded", "W_in unrounded"])
def test_prologue_stage_check_on_cpu(fault):
    h, w_in, conv_w, conv_b = map(torch.from_numpy, _prologue_operands(1, 8, 8, 40, 36, seed=2))
    v = check_prologue_serving(h, w_in, conv_w, conv_b,
                               _planted_prologue(fault, h, w_in, conv_w, conv_b))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("fault", ["none", "W_xp unrounded", "y truncated"])
@pytest.mark.parametrize("shift", [False, True])
def test_scan_stage_check_on_cpu(fault, shift):
    ops = _torch(_scan_operands(1, 8, 12, 24, 4, 2, seed=3), bf16=("x",))
    v = check_scan_serving(**ops, scan_len=4, shift=shift, st=_planted_scan(fault, ops, shift))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("fault", ["none", "gated rows unrounded", "W_out unrounded"])
def test_epilogue_stage_check_on_cpu(fault):
    ops = _torch(_epilogue_operands(1, 8, 8, 34, 20, seed=4), bf16=("y", "z"))
    v = check_epilogue_serving(**ops, st=_planted_epilogue(fault, ops))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("name", [*serving_mutants.MIXER_MUTANTS, *serving_mutants.MIXER_REPORTED])
def test_mixer_serving_mutants_apply_to_the_sources(name, tmp_path):
    """The card's mutation controls for the three bodies
    (``utils/serving_mutants.py --bodies mixer``) still plant each fault in
    the current sources, on a copy."""
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc"),
                    tmp_path / "csrc")
    edits = {**serving_mutants.MIXER_MUTANTS, **serving_mutants.MIXER_REPORTED}[name]
    serving_mutants.plant(str(tmp_path), edits)


# --- the CUDA kernels against the stage checks, on a card -------------------


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,dm,di", [(2, 32, 24, 180, 234), (2, 16, 16, 20, 28),
                                         (1, 9, 13, 33, 65)])
def test_prologue_serving_kernel_on_card(cuda_device, B, H, W, dm, di):
    """Every stage within its check, bit for bit on repeat, the wrapper's
    output the stage entry's, one launch under its own name."""
    h, w_in, conv_w, conv_b = (torch.from_numpy(a).to(cuda_device)
                               for a in _prologue_operands(B, H, W, dm, di, seed=di))
    st = mixer_prologue_serving_stages(h, w_in, conv_w, conv_b)
    again = mixer_prologue_serving_stages(h, w_in, conv_w, conv_b)
    before = dict(_kernels.LAUNCHES)
    x, z = mixer_prologue(h, w_in, conv_w, conv_b, serving=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["mixer_prologue_serving"] == before["mixer_prologue_serving"] + 1
    assert _kernels.LAUNCHES["mixer_prologue"] == before["mixer_prologue"]
    assert _same(st, again) and torch.equal(x, st["x"]) and torch.equal(z, st["z"])
    v = check_prologue_serving(h, w_in, conv_w, conv_b, st)
    assert all(s.ok for s in v), v


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,d,n,r", [(2, 32, 32, 234, 16, 12), (1, 24, 16, 234, 16, 12),
                                         (2, 16, 24, 40, 8, 3), (2, 8, 8, 6, 3, 2),
                                         (1, 16, 16, 96, 32, 6)])
def test_scan_serving_kernel_on_card(cuda_device, shift, B, H, W, d, n, r):
    """Every stage within its check, bit for bit on repeat, the wrapper's
    output the stage entry's, one launch under its own name."""
    ops = _torch(_scan_operands(B, H, W, d, n, r, seed=d + n), cuda_device, bf16=("x",))
    st = nss_scan_serving_stages(**ops, shift=shift)
    st = {k: v.clone() for k, v in st.items()}
    again = nss_scan_serving_stages(**ops, shift=shift)
    before = dict(_kernels.LAUNCHES)
    y, pooled = nss_scan(**ops, shift=shift, serving=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["nss_scan_serving"] == before["nss_scan_serving"] + 1
    assert _kernels.LAUNCHES["nss_scan"] == before["nss_scan"]
    assert _same(st, again) and torch.equal(y, st["y"]) and torch.equal(pooled, st["pooled"])
    v = check_scan_serving(**ops, scan_len=4, shift=shift, st=st)
    assert all(s.ok for s in v), v


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,di,dm", [(2, 16, 24, 234, 180), (2, 8, 8, 12, 10),
                                         (1, 7, 9, 192, 96), (1, 11, 13, 33, 20)])
def test_epilogue_serving_kernel_on_card(cuda_device, B, H, W, di, dm):
    """Every stage within its check (d_inner a multiple of 4, even, odd: the
    three load widths), bit for bit on repeat, the wrapper's output the
    stage entry's, one launch under its own name."""
    ops = _torch(_epilogue_operands(B, H, W, di, dm, seed=di), cuda_device, bf16=("y", "z"))
    st = mixer_epilogue_serving_stages(**ops)
    again = mixer_epilogue_serving_stages(**ops)
    before = dict(_kernels.LAUNCHES)
    out = mixer_epilogue(**ops, serving=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["mixer_epilogue_serving"] == before["mixer_epilogue_serving"] + 1
    assert _kernels.LAUNCHES["mixer_epilogue"] == before["mixer_epilogue"]
    assert _same(st, again) and torch.equal(out, st["out"])
    v = check_epilogue_serving(**ops, st=st)
    assert all(s.ok for s in v), v
