"""The serving bodies of MaIR's scans off the stripe route in the port (K3,
the sequence route's scan with fused projections; K5, the fused route's
gather-free NSS scan): their plain versions against tpuir's kernels with
``serving=True`` in interpret mode on the same inputs, the wrappers' dtype
checks, the stage checks of ``utils/serving_check.py`` against the plain
versions and planted faults on the CPU, the bf16 SiLU of those routes' tail
against ``jax.nn.silu``, and the CUDA kernels against the stage checks on a
card.

The tolerances: K3's float32 y within 2e-5 max(|ref|, 1) of tpuir's; K5's
bf16 y within two bf16 ulps, 2^-6 max(|ref|, 1), of tpuir's; for both the
mean difference within 1/20 of the mean gap between tpuir's serving and
parity outputs on the same inputs; K5's pooled within the parity scan
tolerance 5e-5 + 1e-3 sum|y|. Inputs come from NumPy seeds; JAX is imported
only on the reference side, so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpuir_torch.models.mair import silu_bf16
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_fused import (fused_serving_values, nss_scan_fused,
                                       nss_scan_fused_serving_plain,
                                       nss_scan_fused_serving_stages)
from tpuir_torch.ops.nss_stripe import scan_from_xdbl, seq_scan_from_xdbl
from tpuir_torch.ops.scan_fused_proj import (selective_scan_fused_proj,
                                             selective_scan_fused_proj_serving_plain,
                                             selective_scan_fused_proj_serving_stages,
                                             seq_scan_serving_values)
from tpuir_torch.utils import serving_mutants
from tpuir_torch.utils.serving_check import check_fused_scan_serving, check_seq_scan_serving
from tests.torch_threads import one_torch_thread  # noqa: F401

SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # tests/test_torch_nss.py's parity scan tolerance
GAP_SHARE = 1 / 20  # the mean difference, as a share of the serving-parity gap
K3_RTOL = 2e-5  # K3's float32 y against tpuir's, as a share of max(|ref|, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 a rounded to bf16 (nearest even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _weights(rng, d, n, r):
    """The scan weights as the port takes them (A already -exp), the
    projections scaled by their fan-in."""
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x_proj_w=f(4, r + 2 * n, d) / np.float32(np.sqrt(d)),
                dt_w=f(4, d, r) / np.float32(np.sqrt(r)),
                A=-np.exp(f(4, d, n) * np.float32(0.3)).astype(np.float32),
                D=f(4, d) * np.float32(0.3), delta_bias=f(4, d) * np.float32(0.3))


def _seq_operands(B, L, d, n, r, seed):
    """K3's xs (B, 4, L, d) as bf16 values (float32) and its weights."""
    rng = np.random.RandomState(seed)
    return dict(xs=_bf16(rng.randn(B, 4, L, d)), **_weights(rng, d, n, r))


def _fused_operands(B, H, W, d, n, r, seed):
    """K5's x (B, H, W, d) as bf16 values (float32) and its weights."""
    rng = np.random.RandomState(seed)
    return dict(x=_bf16(rng.randn(B, H, W, d)), **_weights(rng, d, n, r))


def _torch(d, device="cpu", bf16=()):
    """NumPy operands as tensors; the names in ``bf16`` as bf16 tensors."""
    return {k: torch.from_numpy(v).to(device).to(torch.bfloat16 if k in bf16 else torch.float32)
            for k, v in d.items()}


def _unchanged(fn):
    """fn() with the launch counts checked unchanged (a CPU tensor takes the
    plain version)."""
    before = dict(_kernels.LAUNCHES)
    out = fn()
    assert _kernels.LAUNCHES == before
    return out


def _assert_gap(got, want, parity, what):
    """The mean difference within GAP_SHARE of the mean |tpuir serving -
    tpuir parity|."""
    err, gap = np.abs(got - want).mean(), np.abs(want - parity).mean()
    assert gap > 0, what
    assert err <= GAP_SHARE * gap, (what, err, gap)


# --- the plain serving versions against tpuir's serving kernels -------------


# tests/test_torch_scan_fused.py's shapes, with d_state 4, 8, 16 and 32 (d even)
@pytest.mark.parametrize("B,L,d,n,r", [(1, 64, 24, 4, 2), (2, 100, 12, 8, 2),
                                       (1, 70, 40, 32, 3), (1, 48, 20, 16, 2)])
def test_seq_scan_serving_plain_matches_jax_kernel(B, L, d, n, r):
    """tpuir's K3 (``algo="vert"``) with serving=True on the same bf16 xs."""
    import jax.numpy as jnp

    from tpuir.ops import scan_pallas as sp

    ops = _seq_operands(B, L, d, n, r, seed=L + n)
    j = [jnp.asarray(ops[k]) for k in ("xs", "x_proj_w", "dt_w", "A", "D", "delta_bias")]
    j16 = [j[0].astype(jnp.bfloat16), *j[1:]]
    serving = np.asarray(sp.selective_scan_fused_proj(*j16, chunk=16, serving=True,
                                                      interpret=True), np.float64)
    parity = np.asarray(sp.selective_scan_fused_proj(*j, chunk=16, interpret=True), np.float64)
    y = _unchanged(lambda: selective_scan_fused_proj(**_torch(ops, bf16=("xs",)), serving=True))
    assert y.dtype == torch.float32 and y.shape == (B, 4, L, d)
    got = y.double().numpy()
    err = np.abs(got - serving)
    assert (err <= K3_RTOL * np.maximum(np.abs(serving), 1.0)).all(), err.max()
    _assert_gap(got, serving, parity, "y")


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("H,W", [(8, 8), (8, 12)])
def test_fused_scan_serving_plain_matches_jax_kernel(H, W, shift):
    """tpuir's K5 with serving=True (which rounds x to bf16 itself) on the
    same bf16 values of x."""
    import jax.numpy as jnp

    from tpuir.ops import nss_fused as jf

    B, d, n, r = 2, 6, 3, 2
    ops = _fused_operands(B, H, W, d, n, r, seed=H * W + shift)
    j = {k: jnp.asarray(v) for k, v in ops.items()}

    def tpuir(serving):
        out = jf.nss_scan_fused(j["x"], j["x_proj_w"], j["dt_w"], j["A"], j["D"],
                                j["delta_bias"], scan_len=4, shift=shift, serving=serving,
                                vert_p=4, interpret=True)
        return [np.asarray(o, np.float64) for o in out]

    (s01, s23, spool), (p01, p23, _) = tpuir(True), tpuir(False)
    y01, y23, pooled = _unchanged(lambda: nss_scan_fused(
        **_torch(ops, bf16=("x",)), scan_len=4, shift=shift, serving=True))
    assert y01.dtype == y23.dtype == torch.bfloat16 and pooled.dtype == torch.float32
    assert y01.shape == (B, 2, H, W, d) and y23.shape == (B, 2, W, H, d)
    assert pooled.shape == (B, 4, d)
    got = np.concatenate([y01.double().numpy().ravel(), y23.double().numpy().ravel()])
    want = np.concatenate([s01.ravel(), s23.ravel()])
    err = np.abs(got - want)
    assert (err <= 2.0 ** -6 * np.maximum(np.abs(want), 1.0)).all(), err.max()
    _assert_gap(got, want, np.concatenate([p01.ravel(), p23.ravel()]), "y")
    sum_y = np.concatenate([np.abs(s01).sum((2, 3)), np.abs(s23).sum((2, 3))], 1)
    err = np.abs(pooled.double().numpy() - spool)
    assert (err <= SCAN_ATOL + SCAN_RTOL * sum_y).all(), err.max()


def test_silu_bf16_is_jax_silu_bit_for_bit():
    """The serving tail's SiLU equals ``jax.nn.silu`` on bf16 (XLA's lowering
    on the CPU, every operation rounded to bf16) on every value of normal
    samples at three scales; ``F.silu`` on bf16 does not."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    for scale in (1.0, 4.0, 20.0):
        z = (rng.randn(100_000) * scale).astype(np.float32)
        zb = torch.from_numpy(z).to(torch.bfloat16)
        want = np.asarray(jax.nn.silu(jnp.asarray(z).astype(jnp.bfloat16)).astype(jnp.float32))
        got = silu_bf16(zb)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert (torch.nn.functional.silu(zb).float().numpy() != want).any()


# --- the wrappers' dtype checks --------------------------------------------


@pytest.mark.parametrize("case", ["k3_f32_xs_serving", "k3_bf16_xs_parity", "k3_odd_d_serving",
                                  "k5_f32_x_serving", "k5_bf16_x_parity"])
def test_seq_wrappers_reject_the_other_modes_dtypes(case):
    seq = _torch(_seq_operands(1, 16, 6, 3, 2, seed=0))
    odd = _torch(_seq_operands(1, 16, 7, 3, 2, seed=0), bf16=("xs",))
    fused = _torch(_fused_operands(1, 8, 8, 6, 3, 2, seed=0))
    bf = lambda d, name: {k: v.to(torch.bfloat16) if k == name else v  # noqa: E731
                          for k, v in d.items()}
    calls = {
        "k3_f32_xs_serving": (TypeError, lambda: selective_scan_fused_proj(**seq, serving=True)),
        "k3_bf16_xs_parity": (TypeError, lambda: selective_scan_fused_proj(**bf(seq, "xs"))),
        "k3_odd_d_serving": (ValueError, lambda: selective_scan_fused_proj(**odd, serving=True)),
        "k5_f32_x_serving": (TypeError, lambda: nss_scan_fused(**fused, serving=True)),
        "k5_bf16_x_parity": (TypeError, lambda: nss_scan_fused(**bf(fused, "x"))),
    }
    exc, call = calls[case]
    with pytest.raises(exc):
        call()


def test_seq_serving_stage_entries_are_the_plain_versions_on_cpu():
    """On a CPU tensor each stage entry returns the plain version's stages,
    whose outputs are the plain version's, and launches nothing."""
    seq = _torch(_seq_operands(1, 40, 10, 5, 3, seed=1), bf16=("xs",))
    st = _unchanged(lambda: selective_scan_fused_proj_serving_stages(**seq))
    assert torch.equal(st["y"], selective_scan_fused_proj_serving_plain(**seq))
    assert st["x_dbl"].shape == (1, 4, 40, 3 + 2 * 5) and st["x_dbl"].dtype == torch.float32
    fused = _torch(_fused_operands(1, 8, 12, 12, 3, 2, seed=1), bf16=("x",))
    st = _unchanged(lambda: nss_scan_fused_serving_stages(**fused, shift=True))
    for got, want in zip((st["y01"], st["y23"], st["pooled"]),
                         nss_scan_fused_serving_plain(**fused, shift=True)):
        assert torch.equal(got, want)
    assert st["x_dbl"].shape == (1, 96, 4, 2 + 2 * 3)


# --- the stage checks: the plain versions pass, planted faults do not -------


def _truncate_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 t cut to bf16 toward zero (its low 16 bits dropped)."""
    return (t.float().contiguous().view(torch.int32) & -65536).view(torch.float32).to(
        torch.bfloat16)


def _planted_seq(fault, ops):
    """The plain serving stages of K3, with one fault planted."""
    if fault == "none":
        return seq_scan_serving_values(**ops)
    xw = ops["xs"].float()
    wxp = ops["x_proj_w"] if fault == "W_xp unrounded" else ops["x_proj_w"].to(
        torch.bfloat16).float()
    xdbl = torch.einsum("bkld,kcd->bklc", xw, wxp)
    scan_xdbl = xdbl
    if fault == "B and C rounded":
        r = ops["dt_w"].shape[-1]
        scan_xdbl = torch.cat([xdbl[..., :r], xdbl[..., r:].to(torch.bfloat16).float()], -1)
    y = seq_scan_from_xdbl(xw, scan_xdbl, ops["dt_w"], ops["A"], ops["D"], ops["delta_bias"])
    if fault == "y through bf16":
        y = y.to(torch.bfloat16).float()
    return {"x_dbl": xdbl, "y": y}


def _planted_fused(fault, ops, shift):
    """The plain serving stages of K5, with one fault planted."""
    if fault == "none":
        return fused_serving_values(**ops, scan_len=4, shift=shift)
    x = ops["x"]
    B, H, W, d = x.shape
    xw = x.reshape(B, H * W, d).float()
    wxp = ops["x_proj_w"] if fault == "W_xp unrounded" else ops["x_proj_w"].to(
        torch.bfloat16).float()
    xdbl = torch.einsum("bld,kcd->blkc", xw, wxp).contiguous()
    y, pooled = scan_from_xdbl(xw, xdbl, ops["dt_w"], ops["A"], ops["D"], ops["delta_bias"], H,
                               W, 4, shift)
    y16 = _truncate_bf16(y) if fault == "y truncated" else y.to(torch.bfloat16)
    return {"x_dbl": xdbl, "y01": y16[:, :2], "y23": y16[:, 2:].transpose(2, 3),
            "pooled": pooled}


@pytest.mark.parametrize("fault", ["none", "W_xp unrounded", "B and C rounded",
                                   "y through bf16"])
def test_seq_stage_check_on_cpu(fault):
    ops = _torch(_seq_operands(2, 96, 24, 16, 3, seed=3), bf16=("xs",))
    v = check_seq_scan_serving(**ops, st=_planted_seq(fault, ops))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("fault", ["none", "W_xp unrounded", "y truncated"])
@pytest.mark.parametrize("shift", [False, True])
def test_fused_stage_check_on_cpu(fault, shift):
    ops = _torch(_fused_operands(1, 8, 12, 24, 4, 2, seed=3), bf16=("x",))
    v = check_fused_scan_serving(**ops, scan_len=4, shift=shift,
                                 st=_planted_fused(fault, ops, shift))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("name", [*serving_mutants.SEQ_MUTANTS, *serving_mutants.SEQ_REPORTED])
def test_seq_serving_mutants_apply_to_the_sources(name, tmp_path):
    """The card's mutation controls for K3's and K5's serving bodies
    (``utils/serving_mutants.py --bodies seq``) still plant each fault in
    the current sources, on a copy."""
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc"),
                    tmp_path / "csrc")
    edits = {**serving_mutants.SEQ_MUTANTS, **serving_mutants.SEQ_REPORTED}[name]
    serving_mutants.plant(str(tmp_path), edits)


@pytest.mark.parametrize("name,rebuilt", [
    ("K3 y through bf16", {"scan_fused_proj.cu"}),
    ("K5 y truncated", {"nss_fused.cu", "nss_scan.cu", "scan_fused_proj.cu", "selective_scan.cu"}),
    ("K3+K5 x_proj W_xp unrounded", {"nss_fused.cu", "nss_scan.cu", "scan_fused_proj.cu"}),
])
def test_mutant_copies_recompile_only_what_their_fault_reaches(monkeypatch, tmp_path, name,
                                                                rebuilt):
    """A mutant copy starts from the checked tree's objects, each keyed by
    its source and the headers it includes (``ops/_kernels.object_path``),
    so only the sources its fault reaches get a new key."""
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc"),
                    tmp_path / "csrc")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path / "csrc")
    before = {src.name: _kernels.object_path(src) for src in _kernels._sources()}
    serving_mutants.plant(str(tmp_path), serving_mutants.SEQ_MUTANTS[name])
    after = {src.name: _kernels.object_path(src) for src in _kernels._sources()}
    assert {n for n in before if before[n] != after[n]} == rebuilt


def test_mutant_verdicts_name_their_kernels():
    """A mutant named for kernels ("K3+K5 ...") is rejected only when the
    check of each of them rejects it; "none" when any check does."""
    ok, miss = {"y": [True, ""]}, {"y": [False, ""]}
    res = {"K3 B=1 96x82": miss, "K5 B=2 128x128": ok}
    assert serving_mutants._rejected(res, "K3 B and C rounded")
    assert not serving_mutants._rejected(res, "K5 y truncated")
    assert not serving_mutants._rejected(res, "K3+K5 x_proj W_xp unrounded")
    assert serving_mutants._rejected(res, "none")
    assert serving_mutants._rejected({"K3 a": miss, "K5 b": miss}, "K3+K5 x_proj W_xp unrounded")


# --- the CUDA kernels against the stage checks, on a card -------------------


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,d,n,r", [
    (1, 64, 24, 4, 2), (2, 100, 12, 8, 2), (1, 70, 40, 32, 3), (2, 517, 96, 12, 6),
    (2, 7872, 384, 16, 12),   # MaIRUNet level 3 of a 481x321 request (96x82 tiles)
    (2, 1968, 768, 32, 24),   # its latent level (48x41 tiles)
    (1, 257, 300, 32, 64),    # ragged tile, three channel blocks, over 48 KB of shared memory
])
def test_seq_scan_serving_kernel_on_card(cuda_device, B, L, d, n, r):
    """Every stage within its check, bit for bit on repeat, the wrapper's
    output the stage entry's, one launch under its own name."""
    ops = _torch(_seq_operands(B, L, d, n, r, seed=L + d), cuda_device, bf16=("xs",))
    st = selective_scan_fused_proj_serving_stages(**ops)
    again = selective_scan_fused_proj_serving_stages(**ops)
    before = dict(_kernels.LAUNCHES)
    y = selective_scan_fused_proj(**ops, serving=True)
    torch.cuda.synchronize()
    name = "selective_scan_fused_proj"
    assert _kernels.LAUNCHES[f"{name}_serving"] == before[f"{name}_serving"] + 1
    assert _kernels.LAUNCHES[name] == before[name]
    assert _same(st, again) and torch.equal(y, st["y"])
    v = check_seq_scan_serving(**ops, st=st)
    assert all(s.ok for s in v), v


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,d,n,r", [(2, 32, 32, 234, 16, 12), (1, 24, 16, 234, 16, 12),
                                         (2, 16, 24, 40, 8, 3), (2, 8, 8, 6, 3, 2),
                                         (1, 16, 16, 96, 32, 6)])
def test_fused_scan_serving_kernel_on_card(cuda_device, shift, B, H, W, d, n, r):
    """Every stage within its check, bit for bit on repeat, the wrapper's
    output the stage entry's, one launch under its own name."""
    ops = _torch(_fused_operands(B, H, W, d, n, r, seed=d + n), cuda_device, bf16=("x",))
    st = nss_scan_fused_serving_stages(**ops, shift=shift)
    st = {k: v.clone() for k, v in st.items()}
    again = nss_scan_fused_serving_stages(**ops, shift=shift)
    before = dict(_kernels.LAUNCHES)
    out = nss_scan_fused(**ops, shift=shift, serving=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["nss_scan_fused_serving"] == before["nss_scan_fused_serving"] + 1
    assert _kernels.LAUNCHES["nss_scan_fused"] == before["nss_scan_fused"]
    assert _same(st, again)
    assert all(torch.equal(o, st[k]) for o, k in zip(out, ("y01", "y23", "pooled")))
    v = check_fused_scan_serving(**ops, scan_len=4, shift=shift, st=st)
    assert all(s.ok for s in v), v
