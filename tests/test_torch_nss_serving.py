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

from tpuir_torch.ops import _kernels, nss_stripe
from tpuir_torch.ops.nss_epilogue import (epilogue_serving_values, gated_rows_serving,
                                          mixer_epilogue, mixer_epilogue_serving_plain,
                                          mixer_epilogue_serving_stages, padded_inner)
from tpuir_torch.ops.nss_prologue import (mixer_prologue, mixer_prologue_serving_plain,
                                          mixer_prologue_serving_stages, prologue_serving_values)
from tpuir_torch.ops.nss_stripe import (WALK_LANES, WALK_ONE_CHUNK_SHARE, WALK_TILE, WALK_WAVES,
                                        nss_scan, nss_scan_serving_plain,
                                        nss_scan_serving_stages, scan_from_xdbl,
                                        scan_serving_values, serving_chunks, state_ceiling,
                                        unpack_walk_rows, walk_blocks, walk_row)
from tpuir_torch.utils import k1s_phases, serving_mutants
from tpuir_torch.utils.misc import bf16_padded_rows
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
    assert st["gated"].shape == (1, 8, 12, padded_inner(12, serving=True))
    assert st["gated"].dtype == torch.bfloat16


@pytest.mark.parametrize("d", [33, 180, 384])
def test_bf16_weight_copies_are_the_rounded_weights_with_zero_tails(d):
    """The serving bodies' bf16 copies of W_in (rows of d_model) and W_out
    (rows of d_inner), as the plain versions make them and the stage checks
    hold the kernels' copies to: w rounded to bf16 to nearest even, rows
    padded with zeros to a multiple of 8."""
    rng = np.random.RandomState(d)
    h = torch.from_numpy(rng.randn(1, 2, 3, d).astype(np.float32))
    w_in = torch.from_numpy(rng.randn(2 * 5, d).astype(np.float32))
    conv_w = torch.from_numpy(rng.randn(5, 1, 3, 3).astype(np.float32))
    epi = _torch(_epilogue_operands(1, 2, 3, d, 7, seed=d), bf16=("y", "z"))
    copies = {"W_in": (mixer_prologue_serving_stages(h, w_in, conv_w, torch.zeros(5))["w16"],
                       w_in),
              "W_out": (mixer_epilogue_serving_stages(**epi)["w16"], epi["w_out"])}
    for name, (got, w) in copies.items():
        width = -(-d // 8) * 8
        assert got.dtype == torch.bfloat16 and got.shape == (w.shape[0], width), name
        assert torch.equal(got[:, :d], w.to(torch.bfloat16)), name
        assert bool((got[:, d:] == 0).all()), name
        assert torch.equal(got, bf16_padded_rows(w)), name


# --- the stage checks: the plain versions pass, planted faults do not -------


def _dwconv_edge_fault(xpre, conv_w, conv_b, fault):
    """dw3x3(xpre) + b as a kernel with a planted window fault computes it:
    "edge read across rows", the left and right zero padding replaced by
    the neighbouring rows' pixels (row y's column -1 is row y - 1's last,
    column W row y + 1's first); "window shifted", the window's right column
    at the last pixel of each 16-pixel tile column read one column left
    (the pixel's own)."""
    B, H, W, di = xpre.shape
    t = xpre.permute(0, 3, 1, 2)
    if fault == "edge read across rows":
        flat = F.pad(t.reshape(B, di, H * W), (1, 1))  # zero before the first, after the last
        left = flat[..., 0:H * W:W][..., :H]  # pixel y W - 1, row y's left neighbour
        right = flat[..., W + 1::W][..., :H]  # pixel (y + 1) W, row y's right neighbour
        wide = torch.cat([left[..., None], t, right[..., None]], -1)
        return F.conv2d(wide, conv_w, conv_b, padding=(1, 0), groups=di).permute(0, 2, 3, 1)
    p = F.pad(t, (1, 1, 1, 1))
    right = p[..., 2:].clone()
    edge = torch.arange(W) % 16 == 15
    right[..., edge] = p[..., 1:-1][..., edge]
    out = conv_b.view(1, -1, 1, 1).expand(B, di, H, W).clone()
    for d in range(3):
        for e, cols in enumerate((p[..., :-2], p[..., 1:-1], right)):
            out = out + conv_w[:, 0, d, e].view(1, -1, 1, 1) * cols[:, :, d:d + H]
    return out.permute(0, 2, 3, 1)


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
    if fault in ("edge read across rows", "window shifted"):
        x = _dwconv_edge_fault(xpre, conv_w, conv_b, fault)
    else:
        x = F.conv2d(xpre.permute(0, 3, 1, 2), conv_w, conv_b, padding=1,
                     groups=di).permute(0, 2, 3, 1)
    z = xz[..., di:].contiguous()
    return {"w16": st["w16"], "xpre": xpre, "x": F.silu(x).to(torch.bfloat16).contiguous(),
            "z": _truncate_bf16(z) if fault == "z truncated" else z.to(torch.bfloat16)}


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
    if fault == "gated rows truncated":
        gated = F.pad(_truncate_bf16(g), (0, st["gated"].shape[-1] - di))
        return {"w16": st["w16"], "gated": gated,
                "out": F.linear(gated[..., :di].float(), st["w16"][:, :di].float())}
    a = g if fault == "gated rows unrounded" else g.to(torch.bfloat16).float()
    w = ops["w_out"] if fault == "W_out unrounded" else ops["w_out"].to(torch.bfloat16).float()
    return {"w16": st["w16"], "gated": st["gated"], "out": F.linear(a[..., :di], w)}


@pytest.mark.parametrize("fault", ["none", "h unrounded", "W_in unrounded",
                                   "edge read across rows", "z truncated", "window shifted"])
def test_prologue_stage_check_on_cpu(fault):
    h, w_in, conv_w, conv_b = map(torch.from_numpy, _prologue_operands(1, 8, 20, 40, 36, seed=2))
    v = check_prologue_serving(h, w_in, conv_w, conv_b,
                               _planted_prologue(fault, h, w_in, conv_w, conv_b))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("fault", ["none", "W_xp unrounded", "y truncated"])
@pytest.mark.parametrize("shift", [False, True])
def test_scan_stage_check_on_cpu(fault, shift):
    ops = _torch(_scan_operands(1, 8, 12, 24, 4, 2, seed=3), bf16=("x",))
    v = check_scan_serving(**ops, scan_len=4, shift=shift, st=_planted_scan(fault, ops, shift))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("fault", ["none", "gated rows unrounded", "W_out unrounded",
                                   "gated rows truncated"])
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


# --- the serving walk's chunks and packed rows ------------------------------

# (label, B, H, W, d, N): MaIR-CDN@128 and MaIRUNet@384's five levels, batch
# 8, then K5's tiles of the 481x321 request on the fused route, batch 2
# (384x328 at both level-1 widths, 192x164 at level 2)
WALK_SHAPES = [("MaIR-CDN@128", 8, 128, 128, 234, 16), ("enc-1", 8, 384, 384, 96, 4),
               ("dec-1", 8, 384, 384, 192, 8), ("level-2", 8, 192, 192, 192, 8),
               ("level-3", 8, 96, 96, 384, 16), ("latent", 8, 48, 48, 768, 32),
               ("K5 384x328 enc-1", 2, 384, 328, 96, 4), ("K5 384x328 dec-1", 2, 384, 328, 192, 8),
               ("K5 192x164", 2, 192, 164, 192, 8)]


@pytest.mark.parametrize("sms,resident", [(132, 4), (132, 5), (114, 4), (16, 8)])
@pytest.mark.parametrize("label,B,H,W,d,n", WALK_SHAPES + [("tiny", 1, 8, 8, 6, 3)])
def test_serving_chunk_rule(label, B, H, W, d, n, sms, resident):
    """The walk's chunk count (K2's and K5's serving bodies) on a card of
    ``sms`` SMs that holds ``resident`` of its blocks an SM: chunks of whole
    tiles but the last, covering L once; no more chunks than L has tiles;
    one chunk where one chunk's blocks fill WALK_ONE_CHUNK_SHARE of the
    card, else the most whose blocks fill WALK_WAVES waves of it (or every
    tile its own chunk)."""
    L = H * W
    chunks, chunk = serving_chunks(B, L, d, n, sms, resident)
    assert chunk > 0 and chunk % WALK_TILE == 0
    assert (chunks - 1) * chunk < L <= chunks * chunk
    tiles = -(-L // WALK_TILE)
    assert 1 <= chunks <= tiles
    cb = 4 * 32 // WALK_LANES[state_ceiling(n)]  # channels a block
    blocks, card = B * 4 * -(-d // cb), resident * sms
    assert walk_blocks(B, d, n) == blocks
    if blocks >= WALK_ONE_CHUNK_SHARE * card:
        assert chunks == 1
    else:
        assert chunks * blocks <= WALK_WAVES * card
        # one tile less a chunk would take more chunks than the waves hold
        assert chunks == tiles or -(-L // (chunk - WALK_TILE)) * blocks > WALK_WAVES * card
    if (sms, resident) == (132, 4):  # the H100 at the walk's 4 blocks an SM
        assert (chunks == 1) == (label in ("MaIR-CDN@128", "level-3", "latent")), (label, chunks)


@pytest.mark.parametrize("n,r", [(3, 2), (4, 3), (8, 6), (16, 12), (32, 24)])
def test_walk_rows_unpack(n, r):
    """The serving kernel's packed x_dbl rows [dt_r (R, zeros to R4) | B
    (MAXN) | C (MAXN)] unpack to (B, L, 4, R + 2N) in order."""
    r4, maxn, cs = walk_row(n, r)
    assert r4 % 4 == 0 and r4 - 4 < r <= r4 and maxn >= n and cs == r4 + 2 * maxn
    want = torch.randn(2, 5, 4, r + 2 * n)
    packed = torch.zeros(2, 5, 4, cs)
    packed[..., :r] = want[..., :r]
    packed[..., r4:r4 + n] = want[..., r:r + n]
    packed[..., r4 + maxn:r4 + maxn + n] = want[..., r + n:]
    assert torch.equal(unpack_walk_rows(packed, n, r), want)


@pytest.mark.parametrize("name", list(k1s_phases.K6S_PHASES))
def test_k6s_phases_apply_to_the_sources(name, tmp_path):
    """The phase-removal timings of K6's serving kernel
    (``utils/k1s_phases.py --body K6s``) still take each phase out of the
    current source, on a copy."""
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..", "csrc"),
                    tmp_path / "csrc")
    serving_mutants.plant(str(tmp_path), k1s_phases.K6S_PHASES[name])


def test_pass_phases_time_a_body_that_runs_the_passes(tmp_path):
    """``k1s_phases.py --body passes`` times K5's serving body on a tree
    whose serving body runs the chunked passes, else the parity bodies of K2
    and K5; the walk's bodies are timed through their own serving body."""
    src = tmp_path / "tpuir_torch" / "csrc"
    src.mkdir(parents=True)
    (src / "chunk_scan.cuh").write_text("struct StripeBf16Path {};\n")
    assert k1s_phases.scan_kernels("passes", str(tmp_path)) == "K5s"
    here = os.path.join(os.path.dirname(_kernels.__file__), "..", "..")
    assert k1s_phases.scan_kernels("passes", here) == "K2,K5"
    assert [k1s_phases.scan_kernels(b, here) for b in ("K2s", "K5s", "K2s-layouts")] == [
        "K2s", "K5s", "K2s"]


@pytest.mark.parametrize("body,name", [(b, n) for b in ("K2s", "K5s", "passes", "K2s-layouts")
                                       for n in k1s_phases.BODIES[b]])
def test_k2s_phases_apply_to_the_sources(body, name, tmp_path):
    """The phase-removal timings of the serving walk (through K2's or K5's
    body) and of the chunked passes, and the walk's layout choices
    (``utils/k1s_phases.py --body K2s|K5s|passes|K2s-layouts``), still apply
    to the current sources, on a copy."""
    pkg = os.path.join(os.path.dirname(_kernels.__file__), "..")
    for sub in ("csrc", "ops"):
        shutil.copytree(os.path.join(pkg, sub), tmp_path / sub)
    serving_mutants.plant(str(tmp_path), k1s_phases.BODIES[body][name])


# --- the CUDA kernels against the stage checks, on a card -------------------


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,dm,di", [(2, 32, 24, 180, 234), (2, 16, 16, 20, 28),
                                         (1, 9, 13, 33, 65), (1, 12, 12, 384, 768),
                                         (2, 41, 48, 192, 384)])
def test_prologue_serving_kernel_on_card(cuda_device, B, H, W, dm, di):
    """Every stage within its check, bit for bit on repeat, the wrapper's
    output the stage entry's, one launch under its own name (MaIR-CDN's
    widths, odd ones, MaIRUNet's latent and a ragged level at d_model 192:
    the shared memory's two sizes)."""
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
@pytest.mark.parametrize("B,H,W,d,n,r,chunk", [
    (2, 32, 32, 234, 16, 12, None), (1, 24, 16, 234, 16, 12, None), (2, 16, 24, 40, 8, 3, None),
    (2, 8, 8, 6, 3, 2, None), (1, 16, 16, 96, 32, 6, None),
    # one chunk (N 16, 32) and several (N 4, 8) on an H100
    (8, 16, 16, 768, 16, 12, None), (8, 16, 16, 768, 32, 24, None),
    (8, 64, 64, 96, 4, 3, None), (4, 48, 48, 192, 8, 6, None), (8, 32, 32, 234, 16, 12, None),
    # forced to 14 chunks of 96 positions, the last of 48
    (1, 36, 36, 234, 16, 12, 96)])
def test_scan_serving_kernel_on_card(cuda_device, monkeypatch, shift, B, H, W, d, n, r, chunk):
    """Every stage within its check, bit for bit on repeat, the wrapper's
    output the stage entry's, one launch under its own name; at the walk's
    own chunk count or, with ``chunk``, at that many positions a chunk."""
    if chunk is not None:
        L = H * W
        assert -(-L // chunk) >= 3 and L % chunk
        monkeypatch.setattr(nss_stripe, "serving_chunks", lambda *a: (-(-L // chunk), chunk))
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
