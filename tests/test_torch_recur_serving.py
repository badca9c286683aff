"""K2's bf16-recurrence serving body in the port (``recur_bf16``) against
tpuir's on the CPU, and its CUDA kernel against its stage check on a card.

tpuir's body is ``nss_scan_stripe_pre(..., serving=True, recur_bf16=True,
vert_p=16, interpret=True)``, the stripe kernel as its mixer calls it under
``TPUIR_RECUR_BF16=1``: a bf16 level-1 recurrence restarted every ``rp``
stripe rows and a float32 level-2 carry. The port's plain version follows
that kernel's rounding points as XLA runs it on the CPU (the product
hA * bf16(carry) rounded, its sum with hB not); the tolerance is tpuir's
serving rule: every bf16 output within two bf16 ulps, 2^-6 max(|ref|, 1), of
tpuir's, and the mean difference within 1/20 of the mean gap between
tpuir's recur output and its float32-recurrence serving output on the same
inputs; pooled within 5e-5 + 1e-3 sum|y|. A plain version with rp halved
must fail both rules. At model level the port's other serving bodies
already differ from tpuir's in last bits, which the bf16 recurrence turns
into rounding noise of its own, so the model test holds the element rule
and the mean within 1/4 of that gap, and the port's recur output must be
nearer tpuir's than its own float32-recurrence output is. JAX is imported
only on the reference side, so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.models.mair import MaIR, SSMixer, init_state_dict
from tpuir_torch.models.mair_unet import MaIRUNet
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_stripe import (VERT_P, nss_scan, nss_scan_recur_plain,
                                        nss_scan_recur_stages, recur_from_xdbl,
                                        scan_recur_values)
from tpuir_torch.ops.scan_ids import (mair_scan_ids, mair_subchunk_layout, mair_subchunk_offsets,
                                      mair_subchunk_starts, subchunk_rows)
from tpuir_torch.utils import serving_mutants
from tpuir_torch.utils.serving_check import check_nss_scan_recur_serving
from tests.torch_threads import one_torch_thread  # noqa: F401

SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3  # tests/test_torch_nss.py's parity scan tolerance
GAP_SHARE = 1 / 20  # the mean difference, as a share of the recur gap
MODEL_GAP_SHARE = 1 / 4  # the same at model level (see the module docstring)
TINY = dict(embed_dim=32, depths=(2, 2), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0, scan_len=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(a: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _scan_operands(B, H, W, d, n, r, seed):
    """x (bf16 values, as float32) and the scan weights, the projections
    scaled by their fan-in (as tests/test_torch_nss_serving.py makes them)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=_bf16(f(B, H, W, d)), x_proj_w=f(4, r + 2 * n, d) / np.float32(np.sqrt(d)),
        dt_w=f(4, d, r) / np.float32(np.sqrt(r)),
        A=-np.exp(f(4, d, n) * np.float32(0.3)).astype(np.float32),
        D=f(4, d) * np.float32(0.3), delta_bias=f(4, d) * np.float32(0.3),
    )


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device).to(torch.bfloat16 if k == "x" else torch.float32)
            for k, v in d.items()}


def _unchanged(fn):
    before = dict(_kernels.LAUNCHES)
    out = fn()
    assert _kernels.LAUNCHES == before
    return out


# --- the subchunk table against tpuir's stripe geometry --------------------


def _oriented(k, p, H, W):
    """(row, column) of image pixel p in direction k's oriented grid."""
    i, j = divmod(int(p), W)
    return [(i, j), (H - 1 - i, W - 1 - j), (j, i), (W - 1 - j, H - 1 - i)][k]


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("H,W", [(8, 8), (8, 12), (12, 8), (16, 16), (24, 16), (128, 128),
                                 (96, 72)])
def test_subchunk_table_matches_tpuir_geometry(H, W, shift):
    """A start is the first position of every rp-th row of a stripe, in walk
    order, with rp from tpuir's ``_seg_params`` for that direction's stripe
    length; the stripes and rows come from tpuir's own scan ids."""
    from tpuir.ops import nss_stripe as js
    from tpuir.ops.scan_ids import mair_scan_ids as jax_ids

    sl = 2 if shift else 0
    ids = jax_ids(H, W, 4, sl)[0]
    np.testing.assert_array_equal(mair_scan_ids(H, W, 4, sl)[0], ids)
    starts = mair_subchunk_starts(H, W, 4, sl, VERT_P)
    layout, count = mair_subchunk_layout(H, W, 4, sl, VERT_P)
    for k in range(4):
        n, cols = (H, W) if k < 2 else (W, H)
        rp = js._seg_params(n, 4, 8, 128, VERT_P)[0]
        assert subchunk_rows(n, 4, VERT_P) == rp
        edges = ([0, sl] if sl else [0]) + list(range(sl + 4, cols, 4)) + [cols]
        want, prev, rows = np.zeros(H * W, np.uint8), None, 0
        for t, p in enumerate(ids[k]):
            r, c = _oriented(k, p, H, W)
            stripe = np.searchsorted(edges, c, side="right")
            if prev is None or stripe != prev[0]:
                rows = 0
            elif r != prev[1]:
                rows += 1
            if prev is None or stripe != prev[0] or r != prev[1]:
                want[t] = rows % rp == 0
            prev = (stripe, r)
        np.testing.assert_array_equal(starts[k], want, err_msg=f"k={k}")
        # the layout and the kernel's offsets list the same subchunks, in order
        firsts = layout[k, :count[k], 0]
        np.testing.assert_array_equal(firsts, np.flatnonzero(want))
        off = mair_subchunk_offsets(H, W, 4, sl, VERT_P)
        assert off.shape == (4, layout.shape[1] + 1)
        np.testing.assert_array_equal(off[k, :count[k]], firsts)
        assert (off[k, count[k]:] == H * W).all()
        live = layout[k][layout[k] >= 0]
        np.testing.assert_array_equal(live, np.arange(H * W))
        assert (layout[k, count[k]:] == -1).all()


# --- the plain version against tpuir's recur_bf16 kernel --------------------


def _assert_serving_close(got, want, ref, what, share=GAP_SHARE):
    got, want, ref = (np.asarray(a, np.float64) for a in (got, want, ref))
    err = np.abs(got - want)
    assert (err <= 2.0 ** -6 * np.maximum(np.abs(want), 1.0)).all(), (what, err.max())
    gap = np.abs(want - ref).mean()
    assert gap > 0, what
    assert err.mean() <= share * gap, (what, err.mean() / gap)


@functools.lru_cache(maxsize=None)
def _tpuir_scan(H, W, n, shift):
    """(operands, tpuir recur y (B, 4, H, W, d) and pooled, tpuir f32-recurrence
    serving y): the stripe kernel square (K2b) or rectangular (K2a), one
    direction at a time out of its half buffers through a one-hot gate."""
    import jax.numpy as jnp

    from tpuir.ops import nss_stripe as js

    B, d, r = 1, 6, 2
    ops = _scan_operands(B, H, W, d, n, r, seed=H * W + n + shift)
    j = {k: jnp.asarray(v) for k, v in ops.items()}

    def run(recur):
        xp = jnp.pad(j["x"], ((0, 0), (0, 0), (0, 0), (0, (-d) % 128))).astype(jnp.bfloat16)
        out = js.nss_scan_stripe_pre(xp, jnp.transpose(xp, (0, 2, 1, 3)), j["x_proj_w"],
                                     j["dt_w"], j["A"], j["D"], j["delta_bias"], scan_len=4,
                                     shift=shift, serving=True, vert_p=VERT_P, interpret=True,
                                     recur_bf16=recur)
        ys = [js.combine_halves(*out[:4], jnp.zeros((B, 4, d)).at[:, k].set(1.0), shift, 4)
              for k in range(4)]
        return np.stack([np.asarray(y, np.float32) for y in ys], 1), np.asarray(out[4])

    (yr, pool), (yf, _) = run(True), run(False)
    return ops, yr, pool, yf


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("H,W,n", [(8, 8, 3), (8, 12, 3), (12, 8, 3), (16, 16, 8)])
def test_recur_plain_matches_jax_kernel(H, W, n, shift):
    """The port's plain recur body, through ``nss_scan(serving=True,
    recur_bf16=True)`` on the CPU, within tpuir's serving rule of tpuir's
    recur kernel; at 16x16 the control with rp halved fails both rules."""
    ops, want, pool_want, f32rec = _tpuir_scan(H, W, n, shift)
    t = _torch(ops)
    y, pooled = _unchanged(lambda: nss_scan(**t, scan_len=4, shift=shift, serving=True,
                                            recur_bf16=True))
    assert y.dtype == torch.bfloat16 and pooled.dtype == torch.float32
    assert y.shape == want.shape and pooled.shape == pool_want.shape
    _assert_serving_close(y.float().numpy(), want, f32rec, "y")
    err = np.abs(pooled.numpy() - pool_want)
    assert (err <= SCAN_ATOL + SCAN_RTOL * np.abs(want).sum((2, 3))).all(), err.max()
    if (H, W) == (16, 16):
        B, _, _, d = t["x"].shape
        xw = t["x"].reshape(B, H * W, d).float()
        xdbl = scan_recur_values(**t, scan_len=4, shift=shift)["x_dbl"]
        w = {k: v for k, v in t.items() if k not in ("x", "x_proj_w")}
        rp2, _, _ = recur_from_xdbl(xw, xdbl, **w, H=H, W=W, scan_len=4, shift=shift,
                                    vert_p=VERT_P // 2)
        got, want64 = rp2.to(torch.bfloat16).double().numpy(), want.astype(np.float64)
        err = np.abs(got - want64)
        assert (err > 2.0 ** -6 * np.maximum(np.abs(want64), 1.0)).any()
        assert err.mean() > GAP_SHARE * np.abs(want64 - f32rec).mean()


# --- the wrapper, the stage entry and the stage check on the CPU ------------


def test_recur_wrapper_and_stage_entry_on_cpu():
    """recur_bf16 is a serving body; on a CPU tensor the wrapper and the
    stage entry run the plain version and launch nothing."""
    t = _torch(_scan_operands(1, 8, 12, 12, 3, 2, seed=1))
    with pytest.raises(ValueError):
        nss_scan(**{**t, "x": t["x"].float()}, recur_bf16=True)
    st = _unchanged(lambda: nss_scan_recur_stages(**t, shift=True))
    y, pooled = _unchanged(lambda: nss_scan_recur_plain(**t, shift=True))
    assert torch.equal(st["y"], y) and torch.equal(st["pooled"], pooled)
    S = mair_subchunk_layout(8, 12, 4, 2, VERT_P)[0].shape[1]
    assert st["x_dbl"].shape == (1, 96, 4, 2 + 2 * 3) and st["carries"].shape == (1, 4, S, 12, 3)
    serving_y, _ = nss_scan(**t, shift=True, serving=True)
    assert not torch.equal(serving_y, y)


def _planted(fault, ops, shift):
    """The plain recur stages with one fault planted."""
    st = dict(scan_recur_values(**ops, scan_len=4, shift=shift))
    B, H, W, d = ops["x"].shape
    w = {k: v for k, v in ops.items() if k not in ("x", "x_proj_w")}
    xw = ops["x"].reshape(B, H * W, d).float()
    if fault == "rp 2":
        y, st["pooled"], st["carries"] = recur_from_xdbl(
            xw, st["x_dbl"], **w, H=H, W=W, scan_len=4, shift=shift, vert_p=VERT_P // 2)
        st["y"] = y.to(torch.bfloat16)
    elif fault == "y truncated":  # rounded toward zero, not to nearest even
        y = recur_from_xdbl(xw, st["x_dbl"], **w, H=H, W=W, scan_len=4, shift=shift)[0]
        st["y"] = (y.contiguous().view(torch.int32) & -65536).view(torch.float32).to(
            torch.bfloat16)
    elif fault == "one carry off by an ulp":
        c = st["carries"].clone().view(-1)
        i = int(c.abs().argmax())
        c[i] = torch.nextafter(c[i], torch.tensor(float("inf")))
        st["carries"] = c.view_as(st["carries"])
    return st


@pytest.mark.parametrize("fault", ["none", "rp 2", "one carry off by an ulp", "y truncated"])
@pytest.mark.parametrize("shift", [False, True])
def test_recur_stage_check_on_cpu(fault, shift):
    ops = _torch(_scan_operands(1, 16, 12, 24, 4, 2, seed=3))
    v = check_nss_scan_recur_serving(**ops, scan_len=4, shift=shift,
                                     st=_planted(fault, ops, shift))
    assert all(s.ok for s in v) == (fault == "none"), v


@pytest.mark.parametrize("name", list(serving_mutants.RECUR_MUTANTS))
def test_recur_mutants_apply_to_the_sources(name, tmp_path):
    """The card's mutation controls (``utils/serving_mutants.py --bodies
    recur``) still plant each fault in the current sources, on a copy."""
    pkg = os.path.join(os.path.dirname(_kernels.__file__), "..")
    shutil.copytree(pkg, tmp_path / "tpuir_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    serving_mutants.plant(str(tmp_path / "tpuir_torch"), serving_mutants.RECUR_MUTANTS[name])


# --- the model and the zoo's knob -------------------------------------------


@functools.lru_cache(maxsize=None)
def _state_dict():
    return init_state_dict(TINY, seed=0)


def _port_net(**kw):
    net = MaIR(**TINY, fused=True, serving=True, **kw)
    net.load_state_dict(_state_dict())
    return net.eval()


def test_tiny_mair_recur_matches_tpuir(monkeypatch):
    """The tiny MaIR-CDN in serving precision with recur_bf16 against tpuir's
    ``MaIR(scan_io_dtype="bfloat16")`` under ``TPUIR_FUSED_INTERPRET=1
    TPUIR_RECUR_BF16=1`` at 24x16: every element within two bf16 ulps, the
    mean difference within MODEL_GAP_SHARE of the mean gap between tpuir's
    recur and float32-recurrence outputs, and nearer tpuir's recur output
    than the port's float32-recurrence output is."""
    from tpuir.models import mair as jm

    params = jm.convert_state_dict({k: v.numpy() for k, v in _state_dict().items()},
                                   depths=TINY["depths"], embed_dim=TINY["embed_dim"],
                                   ssm_ratio=TINY["ssm_ratio"])
    model = jm.MaIR(embed_dim=TINY["embed_dim"], depths=TINY["depths"], d_state=TINY["d_state"],
                    ssm_ratio=TINY["ssm_ratio"], mlp_ratio=TINY["mlp_ratio"],
                    scan_len=TINY["scan_len"], scan_chunk=64, scan_io_dtype="bfloat16")
    x = np.random.RandomState(24).rand(1, 24, 16, 3).astype(np.float32)
    monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    monkeypatch.setenv("TPUIR_RECUR_BF16", "1")
    want = np.asarray(model.apply(params, x))
    monkeypatch.setenv("TPUIR_RECUR_BF16", "0")
    f32rec = np.asarray(model.apply(params, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = _unchanged(lambda: _port_net(recur_bf16=True)(xt)).permute(0, 2, 3, 1).numpy()
        plain = MaIR(**TINY, fused=False, serving=True, recur_bf16=True)
        plain.load_state_dict(_state_dict())
        assert np.array_equal(plain.eval()(xt).permute(0, 2, 3, 1).numpy(), got)
        ours_f32rec = _port_net()(xt).permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    _assert_serving_close(got, want, f32rec, "out", MODEL_GAP_SHARE)
    assert np.abs(got - want).mean() < np.abs(ours_f32rec - want).mean()


def _mixers(net):
    return [m for m in net.modules() if isinstance(m, SSMixer)]


def test_zoo_recur_knob(monkeypatch, tmp_path):
    """``resolve_recur_bf16`` reads TPUIR_RECUR_BF16 unless told; the zoo's
    MaIR-CDN and MaIRUNet take the recur body only in serving precision."""
    monkeypatch.delenv("TPUIR_RECUR_BF16", raising=False)
    assert zoo.resolve_recur_bf16() is False and zoo.resolve_recur_bf16(True) is True
    monkeypatch.setenv("TPUIR_RECUR_BF16", "1")
    assert zoo.resolve_recur_bf16() is True and zoo.resolve_recur_bf16(False) is False
    cdn = dict(zoo.MAIR_CDN_CONFIG, depths=(1,))
    unet = dict(zoo.MAIR_UNET_CONFIG, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    monkeypatch.setattr(zoo, "MAIR_CDN_CONFIG", cdn)
    monkeypatch.setattr(zoo, "MAIR_UNET_CONFIG", unet)
    from tpuir_torch.models.mair_unet import init_state_dict as unet_sd

    for rel, sd in (("denoising/MaIR_CDN_s15.pth", init_state_dict(cdn, seed=0)),
                    ("denoising/MaIR_RealDN.pth", unet_sd(unet, seed=0))):
        path = tmp_path / "MaIR" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": sd}, path)
    for subtask, sigma in (("gaussian", 15), ("real", None)):
        kw = dict(sigma=sigma, weights_dir=str(tmp_path), device="cpu")
        for precision, want in (("parity", False), ("serving", True)):
            m = zoo.get_model_instance("denoising", subtask, "MaIR", precision=precision, **kw)
            assert all(x.recur_bf16 == want for x in _mixers(m.net)), (subtask, precision)
        m = zoo.get_model_instance("denoising", subtask, "MaIR", precision="serving",
                                   recur_bf16=False, **kw)
        assert not any(x.recur_bf16 for x in _mixers(m.net))
    assert isinstance(m.net, MaIRUNet)


@pytest.mark.parametrize("nss,hw", [("stripe", (16, 16)), ("fused", (16, 16)), ("0", (12, 12))])
def test_recur_knob_acts_on_the_stripe_route_only(nss, hw):
    """In serving, recur_bf16 changes the stripe route's output (to the plain
    recur mixer's) and leaves the fused and sequence routes' bit for bit;
    in parity it changes nothing."""
    def out(serving, recur):
        net = MaIR(**TINY, fused=True, nss=nss, serving=serving, recur_bf16=recur)
        net.load_state_dict(_state_dict())
        with torch.inference_mode():
            return net.eval()(torch.from_numpy(
                np.random.RandomState(1).rand(1, 3, *hw).astype(np.float32)))

    assert torch.equal(out(False, True), out(False, False))
    assert torch.equal(out(True, True), out(True, False)) == (nss != "stripe")


# --- the CUDA kernel against its stage check, on a card ---------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,d,n,r", [(2, 32, 32, 234, 16, 12), (1, 24, 16, 234, 16, 12),
                                         (2, 16, 24, 40, 8, 3), (2, 8, 8, 6, 3, 2),
                                         (1, 16, 16, 96, 32, 6), (2, 32, 24, 20, 4, 2)])
def test_recur_kernel_on_card(cuda_device, shift, B, H, W, d, n, r):
    """Every stage within its check (the carries bit for bit), bit for bit
    on repeat, the wrapper's output the stage entry's, one launch under its
    own name."""
    from tpuir_torch.core.engine import true_float32

    ops = _torch(_scan_operands(B, H, W, d, n, r, seed=d + n), cuda_device)
    with true_float32():
        st = {k: v.clone() for k, v in nss_scan_recur_stages(**ops, shift=shift).items()}
        again = nss_scan_recur_stages(**ops, shift=shift)
        before = dict(_kernels.LAUNCHES)
        y, pooled = nss_scan(**ops, shift=shift, serving=True, recur_bf16=True)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["nss_scan_recur_serving"] == before["nss_scan_recur_serving"] + 1
        assert _kernels.LAUNCHES["nss_scan_serving"] == before["nss_scan_serving"]
        assert all(torch.equal(st[k], again[k]) for k in st)
        assert torch.equal(y, st["y"]) and torch.equal(pooled, st["pooled"])
        v = check_nss_scan_recur_serving(**ops, scan_len=4, shift=shift, st=st)
    assert all(s.ok for s in v), v


@pytest.mark.cuda
def test_recur_mutants_on_card(cuda_device):
    """The recur check rejects every planted fault and accepts the copy with
    none (each copy built in its own directory)."""
    verdicts = serving_mutants.run_mutants("recur", jobs=6)
    assert serving_mutants.failures("recur", verdicts) == [], verdicts
