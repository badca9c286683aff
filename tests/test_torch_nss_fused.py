"""K5 in the port (MaIR's gather-free NSS scan) and the mixer's NSS route:
the plain version against the JAX Pallas kernel in interpret mode and
against the JAX composition it replaces, the wrapper's checks, SSMixer and
a tiny MaIR under ``nss="fused"`` against the Flax modules under
``TPUIR_NSS=fused``, the route each level takes under each ``nss``, the
zoo's ``resolve_nss``, and the CUDA kernel against the plain version on a
card.

Inputs come from NumPy seeds. JAX is imported only on the reference side,
so the card tests run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import true_float32
from tpuir_torch.models import mair as pm
from tpuir_torch.models.mair import MaIR, SSMixer, init_state_dict
from tpuir_torch.models.mair_unet import MaIRUNet
from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict
from tpuir_torch.ops import _kernels
from tpuir_torch.ops.nss_fused import nss_scan_fused, nss_scan_fused_plain
from tests.torch_threads import one_torch_thread  # noqa: F401

# the JAX package's tolerances for its kernel against its composition
# (tests/test_nss_fused.py:39-44)
Y_TOL, POOL_TOL = 2e-5, 2e-4
# the JAX package's tolerance for MaIR against the reference (tests/test_mair.py:87)
ATOL, RTOL = 1e-4, 1e-3
# the scan's own, kernel against plain on the card (tests/test_torch_nss.py)
SCAN_ATOL, SCAN_RTOL = 5e-5, 1e-3
TINY = dict(embed_dim=32, depths=(2, 2), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0, scan_len=4)
UNET_TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, ssm_ratio=2.0,
                 flp_ratio=4.0, mlp_ratio=1.5, scan_len=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(B=2, H=8, W=12, d=8, n=4, r=3, seed=0):
    """tests/test_nss_fused.py's make_inputs, as NumPy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, d).astype(np.float32) * 0.5
    wxp = rng.randn(4, r + 2 * n, d).astype(np.float32) * 0.3
    wdt = rng.randn(4, d, r).astype(np.float32) * 0.3
    A = -np.exp(rng.randn(4, d, n).astype(np.float32) * 0.3)
    D = rng.randn(4, d).astype(np.float32)
    bias = rng.randn(4, d).astype(np.float32) * 0.2
    return x, wxp, wdt, A, D, bias


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("hw", [(8, 12), (12, 8), (16, 16)])
def test_plain_matches_jax_kernel_and_reference(shift, hw):
    import jax.numpy as jnp

    from tpuir.ops.nss_fused import _reference
    from tpuir.ops.nss_fused import nss_scan_fused as jax_fused

    H, W = hw
    ops = _operands(H=H, W=W)
    j = [jnp.asarray(a) for a in ops]
    kern = [np.asarray(t) for t in jax_fused(*j, shift=shift, interpret=True)]
    ref = [np.asarray(t) for t in _reference(*j, scan_len=4, shift=shift)]
    before = dict(_kernels.LAUNCHES)
    got = [t.numpy() for t in nss_scan_fused(*_torch(ops), scan_len=4, shift=shift)]
    assert _kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert [g.shape for g in got] == [(2, 2, H, W, 8), (2, 2, W, H, 8), (2, 4, 8)]
    for want in (kern, ref):
        np.testing.assert_allclose(got[0], want[0], atol=Y_TOL, rtol=Y_TOL)
        np.testing.assert_allclose(got[1], want[1], atol=Y_TOL, rtol=Y_TOL)
        np.testing.assert_allclose(got[2], want[2], atol=POOL_TOL, rtol=POOL_TOL)


@pytest.mark.parametrize("hw,scan_len", [((9, 9), 3), ((10, 12), 4), ((12, 10), 4)])
def test_shape_errors_match_jax(hw, scan_len):
    """Odd scan_len, and H or W not a multiple of it: ValueError in both."""
    import jax.numpy as jnp

    from tpuir.ops.nss_fused import nss_scan_fused as jax_fused

    ops = _operands(B=1, H=hw[0], W=hw[1])
    with pytest.raises(ValueError):
        jax_fused(*[jnp.asarray(a) for a in ops], scan_len=scan_len, interpret=True)
    with pytest.raises(ValueError):
        nss_scan_fused(*_torch(ops), scan_len=scan_len)


@pytest.mark.parametrize("fault", ["float64", "not_contiguous", "wide_state", "wide_rank",
                                   "bad_weight", "other_device"])
def test_wrapper_rejects(fault):
    x, wxp, wdt, A, D, bias = _torch(_operands(B=1, H=8, W=8))
    err = ValueError
    if fault == "float64":
        x, err = x.double(), TypeError
    elif fault == "not_contiguous":
        x = x.transpose(1, 2)
    elif fault == "wide_state":
        x, wxp, wdt, A, D, bias = _torch(_operands(B=1, H=8, W=8, n=33))
    elif fault == "wide_rank":
        x, wxp, wdt, A, D, bias = _torch(_operands(B=1, H=8, W=8, r=65))
    elif fault == "bad_weight":
        wdt = wdt[:, :-1].contiguous()
    else:
        A = A.to("meta")
    with pytest.raises(err):
        nss_scan_fused(x, wxp, wdt, A, D, bias)


def _seeded_mixer(seed, nss):
    mixer = SSMixer(32, 4, 1.5, 4, nss=nss).eval()
    sd = init_state_dict(TINY, seed=seed)
    prefix = "layers.0.residual_group.blocks.1.self_attention."
    mixer.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return mixer


@pytest.mark.parametrize("nss", ["fused", "0"])
@pytest.mark.parametrize("shift", [False, True])
def test_ssmixer_matches_flax(monkeypatch, nss, shift):
    """An 8x12 level on the fused route (K5's wrapper) or, under "0", the
    sequence route (K3's), against the Flax mixer under TPUIR_NSS=nss with
    its Pallas kernels in interpret mode."""
    from tpuir.models import mair as jm

    monkeypatch.setenv("TPUIR_NSS", nss)
    monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    mixer = _seeded_mixer(seed=1, nss=nss)
    sd = {f"x.{k}": v.numpy() for k, v in mixer.state_dict().items()}
    params = {"params": jm.convert_ssmixer(sd, "x", mixer.d_inner)}
    x = np.random.RandomState(2).rand(2, 8, 12, 32).astype(np.float32)
    ids = jm.scan_ids_for(8, 12, 4)[int(shift)]
    want = np.asarray(jm.SSMixer(32, 4, 1.5, scan_chunk=16).apply(params, x, ids, shift=shift))
    with torch.inference_mode():
        got = mixer(torch.from_numpy(x), shift).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
def test_tiny_mair_matches_flax(monkeypatch, fused):
    """A tiny MaIR with every mixer on K5's route, against the Flax MaIR
    under TPUIR_NSS=fused in interpret mode, on a 16x24 input."""
    from tpuir.models import mair as jm

    monkeypatch.setenv("TPUIR_NSS", "fused")
    monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    sd = init_state_dict(TINY, seed=0)
    x = np.random.RandomState(3).rand(1, 16, 24, 3).astype(np.float32)
    model = jm.MaIR(embed_dim=32, depths=TINY["depths"], d_state=4, ssm_ratio=1.5,
                    mlp_ratio=2.0, scan_len=4, scan_chunk=64)
    params = jm.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                   depths=TINY["depths"], embed_dim=32, ssm_ratio=1.5)
    want = np.asarray(model.apply(params, x))
    net = MaIR(**TINY, fused=fused, nss="fused")
    net.load_state_dict(sd)
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("nss,want", [
    ("stripe", {"nss_scan": [(24, 40), (12, 20), (12, 20), (24, 40), (24, 40)]}),
    ("fused", {"nss_scan_fused": [(24, 40), (12, 20), (12, 20), (24, 40), (24, 40)]}),
    ("0", {}),
])
def test_levels_take_the_jax_routes(monkeypatch, nss, want):
    """Each MaIRUNet level of a 24x40 input goes through the wrapper of the
    route the JAX module takes under TPUIR_NSS=nss
    (``tpuir/models/mair.py:196-213``): the stripe kernel (K2) or K5 where H
    and W are multiples of scan_len 4, K3 elsewhere and on every level
    under "0". A level on the wrong route would still agree on the CPU."""
    calls = {}
    for name in ("nss_scan", "nss_scan_fused", "selective_scan_fused_proj"):
        fn = getattr(pm, name)

        def spy(x, *a, _name=name, _fn=fn, **k):
            calls.setdefault(_name, []).append(tuple(x.shape[1:3]))
            return _fn(x, *a, **k)

        monkeypatch.setattr(pm, name, spy)
    net = MaIRUNet(**UNET_TINY, nss=nss)
    net.load_state_dict(unet_state_dict(UNET_TINY, seed=0))
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 24, 40).astype(np.float32))
    with torch.inference_mode():
        net.eval()(x)
    seq = calls.pop("selective_scan_fused_proj")
    assert calls == want
    # K3 takes the gathered (B, 4, L, d) sequences: encoder 3 (6x10), the
    # latent (3x5) and decoder 3, and under "0" every level
    assert len(seq) == 8 - sum(len(v) for v in want.values())
    mixer = net.latent[0].self_attention
    expect = {"stripe": ["stripe", "stripe", "sequence", "sequence"],
              "fused": ["fused", "fused", "sequence", "sequence"], "0": ["sequence"] * 4}
    assert [mixer.route(24 >> i, 40 >> i) for i in range(4)] == expect[nss]


def test_mixer_refuses_unknown_route():
    with pytest.raises(ValueError):
        SSMixer(32, 4, 1.5, 4, nss="1")


def test_resolve_nss(monkeypatch):
    monkeypatch.delenv("TPUIR_NSS", raising=False)
    assert zoo.resolve_nss() == "stripe"
    assert zoo.resolve_nss("0") == "0"
    monkeypatch.setenv("TPUIR_NSS", "fused")
    assert zoo.resolve_nss() == "fused"
    assert zoo.resolve_nss("stripe") == "stripe"  # an argument beats the environment
    monkeypatch.setenv("TPUIR_NSS", "1")  # the JAX knob's legacy alias
    assert zoo.resolve_nss() == "fused"
    with pytest.raises(ValueError):
        zoo.resolve_nss("gather")


@pytest.mark.parametrize("env,arg,want", [(None, None, "stripe"), ("1", None, "fused"),
                                          ("fused", "0", "0")])
def test_zoo_builds_mixers_on_the_route(monkeypatch, tmp_path, env, arg, want):
    """get_model_instance passes nss (or TPUIR_NSS) to every mixer."""
    if env is None:
        monkeypatch.delenv("TPUIR_NSS", raising=False)
    else:
        monkeypatch.setenv("TPUIR_NSS", env)
    monkeypatch.setattr(zoo, "MAIR_CDN_CONFIG", TINY)
    path = tmp_path / "MaIR" / "denoising" / "MaIR_CDN_s25.pth"
    path.parent.mkdir(parents=True)
    torch.save({"params": init_state_dict(TINY, seed=0)}, path)
    model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=25,
                                   weights_dir=str(tmp_path), device="cpu", nss=arg)
    mixers = [m for m in model.net.modules() if isinstance(m, SSMixer)]
    assert len(mixers) == 4 and {m.nss for m in mixers} == {want}


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("B,H,W,d,n,r,scan_len", [
    (1, 8, 12, 8, 4, 3, 4),      # W / scan_len odd, H != W
    (2, 12, 8, 8, 4, 3, 4),      # H / scan_len odd
    (1, 16, 16, 24, 5, 2, 4),    # square, ragged d_state
    (1, 20, 28, 40, 16, 3, 4),   # both odd stripe counts, rectangular
    (1, 24, 8, 24, 8, 2, 8),     # scan_len 8: W holds one stripe
    (1, 12, 18, 16, 4, 2, 6),    # scan_len 6: odd half stripes when shifted
    (1, 6, 10, 8, 4, 2, 2),      # scan_len 2
    (2, 96, 72, 234, 16, 12, 4),  # MaIR-CDN's 96x72 tile: several chunks, two channel blocks
    (1, 48, 40, 300, 32, 64, 4),  # three channel blocks, over 48 KB of shared memory
    (2, 16, 20, 100, 16, 7, 4),  # D not a multiple of 32: one block of 128 lanes
])
def test_kernel_matches_plain_on_card(cuda_device, shift, B, H, W, d, n, r, scan_len):
    """The stripe arithmetic against the id table: a wrong map still passes
    on the CPU, where the wrapper takes the plain version."""
    x, wxp, wdt, A, D, bias = _operands(B, H, W, d, n, r, seed=H + W + d)
    # projections scaled by their fan-in, so that x_dbl and dt stay unit-scale at any width
    wxp, wdt = wxp / np.float32(0.3 * np.sqrt(d)), wdt / np.float32(0.3 * np.sqrt(r))
    ops = _torch((x, wxp, wdt, A, D, bias), cuda_device)
    before = _kernels.LAUNCHES["nss_scan_fused"]
    with torch.inference_mode(), true_float32():
        got = nss_scan_fused(*ops, scan_len=scan_len, shift=shift)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["nss_scan_fused"] == before + 1
        again = nss_scan_fused(*ops, scan_len=scan_len, shift=shift)
        want = nss_scan_fused_plain(*ops, scan_len=scan_len, shift=shift)
    for g, a in zip(got, again):
        assert torch.equal(g, a)  # no atomics
    torch.testing.assert_close(got[0], want[0], atol=SCAN_ATOL, rtol=SCAN_RTOL)
    torch.testing.assert_close(got[1], want[1], atol=SCAN_ATOL, rtol=SCAN_RTOL)
    # pooled: a sum over the path of values the two round differently, so its
    # bound scales with the sum of |y| over the path
    bound = SCAN_ATOL + SCAN_RTOL * torch.cat([want[0].abs().sum((2, 3)),
                                               want[1].abs().sum((2, 3))], 1)
    assert bool(((got[2] - want[2]).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [False, True])
def test_kernel_extreme_arguments_on_card(cuda_device, shift):
    """The kernel's MUFU exp2 and two-MUFU softplus where dt * A underflows
    (every other state's |A| near e^4.5) and the softplus arguments reach
    both of its tails (the channels' bias over -20..20)."""
    B, H, W, d, n, r = 2, 16, 24, 100, 16, 7
    x, wxp, wdt, A, D, _ = _operands(B, H, W, d, n, r, seed=d)
    wxp, wdt = wxp / np.float32(0.3 * np.sqrt(d)), wdt / np.float32(0.3 * np.sqrt(r))
    A = A * np.exp(4.5 * (np.arange(n) % 2)).astype(np.float32)
    bias = np.tile(np.linspace(-20, 20, d, dtype=np.float32), (4, 1))
    ops = _torch((x, wxp, wdt, A, D, bias), cuda_device)
    with torch.inference_mode(), true_float32():
        got = nss_scan_fused(*ops, shift=shift)
        again = nss_scan_fused(*ops, shift=shift)
        want = nss_scan_fused_plain(*ops, shift=shift)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    torch.testing.assert_close(got[0], want[0], atol=SCAN_ATOL, rtol=SCAN_RTOL)
    torch.testing.assert_close(got[1], want[1], atol=SCAN_ATOL, rtol=SCAN_RTOL)
    bound = SCAN_ATOL + SCAN_RTOL * torch.cat([want[0].abs().sum((2, 3)),
                                               want[1].abs().sum((2, 3))], 1)
    assert bool(((got[2] - want[2]).abs() <= bound).all())


@pytest.mark.cuda
def test_mixer_fused_route_kernel_matches_plain_on_card(cuda_device):
    """SSMixer on K5's route at MaIR-CDN's widths: the kernel wrapper against
    the plain version on the card."""
    mixer = SSMixer(180, 16, 1.3, 4, nss="fused").eval()
    sd = init_state_dict(dict(TINY, embed_dim=180, d_state=16, ssm_ratio=1.3, depths=(1,)),
                         seed=0)
    prefix = "layers.0.residual_group.blocks.0.self_attention."
    mixer.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    mixer = mixer.to(cuda_device)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 24, 180).astype(np.float32))
    x = x.to(cuda_device)
    with torch.inference_mode(), true_float32():
        before = _kernels.LAUNCHES["nss_scan_fused"]
        got = mixer(x, shift=True)
        assert _kernels.LAUNCHES["nss_scan_fused"] == before + 1
        mixer.fused = False
        want = mixer(x, shift=True)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
