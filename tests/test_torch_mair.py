"""The port's MaIR (SSMixer, MaIRBlock, MaIR) against the Flax modules on the
CPU, on the JAX package's XLA route and on its Pallas route in interpret
mode; the weight carriers (state_dict_from_jax, init_state_dict); the zoo
and the tiled engine against ``tpuir``'s MaIR; and the model's kernel path
against its plain path on a card.

Weights come from ``init_state_dict`` (NumPy RandomState) in the released
checkpoints' layout and reach the JAX package through its own
``convert_ssmixer`` / ``convert_block`` / ``convert_state_dict``. JAX is
imported only on the reference side.
"""

import functools

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import InferenceModel, run_model_inference, true_float32
from tpuir_torch.models.mair import MaIR, MaIRBlock, SSMixer, init_state_dict, state_dict_from_jax
from tpuir_torch.ops import _kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(embed_dim=32, depths=(2, 2), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0, scan_len=4)
# the JAX package's tolerance for MaIR against the reference (tests/test_mair.py:87)
ATOL, RTOL = 1e-4, 1e-3
ROUTES = ["xla", "pallas"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _route(monkeypatch, route):
    """The JAX package's mixer route on the CPU: its XLA reference branch, or
    the stripe branch (K6 -> K2 -> K7 Pallas kernels) in interpret mode."""
    if route == "pallas":
        monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("TPUIR_FUSED_INTERPRET", raising=False)


def _numpy_sd(sd, prefix=""):
    return {f"{prefix}{k}": v.numpy() for k, v in sd.items()}


def _nhwc_input(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _seeded(module, seed):
    """Seeded released-layout weights for a sub-module of a tiny MaIR."""
    sd = init_state_dict(TINY, seed=seed)
    prefix = "layers.0.residual_group.blocks.1."
    own = module.state_dict().keys()
    if isinstance(module, SSMixer):
        prefix += "self_attention."
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    assert sub.keys() == own
    module.load_state_dict(sub)
    return sub


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shift", [False, True])
def test_ssmixer_matches_flax(monkeypatch, route, shift):
    from tpuir.models import mair as jm

    _route(monkeypatch, route)
    mixer = SSMixer(32, 4, 1.5, 4).eval()
    sd = _seeded(mixer, seed=1)
    params = {"params": jm.convert_ssmixer(_numpy_sd(sd, "x."), "x", mixer.d_inner)}
    x = _nhwc_input((2, 8, 12, 32), seed=2)
    ids = jm.scan_ids_for(8, 12, 4)[int(shift)]
    want = np.asarray(jm.SSMixer(32, 4, 1.5, scan_chunk=16).apply(params, x, ids, shift=shift))
    with torch.inference_mode():
        got = mixer(torch.from_numpy(x), shift).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shift", [False, True])
def test_ssmixer_sequence_route_matches_flax(monkeypatch, shift):
    """A 10x14 level: W is not a multiple of scan_len, so both packages take
    the sequence route (the port through K3's wrapper, never K2's)."""
    from tpuir.models import mair as jm
    from tpuir_torch.models import mair as pm

    mixer = SSMixer(32, 4, 1.5, 4).eval()
    sd = _seeded(mixer, seed=5)
    params = {"params": jm.convert_ssmixer(_numpy_sd(sd, "x."), "x", mixer.d_inner)}
    x = _nhwc_input((2, 10, 14, 32), seed=6)
    ids = jm.scan_ids_for(10, 14, 4)[int(shift)]
    want = np.asarray(jm.SSMixer(32, 4, 1.5, scan_chunk=16).apply(params, x, ids, shift=shift))
    calls = []
    for name in ("nss_scan", "selective_scan_fused_proj"):
        fn = getattr(pm, name)
        monkeypatch.setattr(pm, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    assert mixer.route(10, 14) == "sequence" and mixer.route(12, 16) == "stripe"
    with torch.inference_mode():
        got = mixer(torch.from_numpy(x), shift).numpy()
    assert calls == ["selective_scan_fused_proj"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("route", ROUTES)
def test_block_matches_flax(monkeypatch, route):
    from tpuir.models import mair as jm

    _route(monkeypatch, route)
    blk = MaIRBlock(32, 4, 1.5, 2.0, 4).eval()
    sd = _seeded(blk, seed=3)
    params = {"params": jm.convert_block(_numpy_sd(sd, "b."), "b", blk.self_attention.d_inner,
                                         "conv_blk")}
    x = _nhwc_input((1, 16, 8, 32), seed=4)
    ids = jm.scan_ids_for(16, 8, 4)[1]
    want = np.asarray(jm.MaIRBlock(32, 4, 1.5, 2.0, scan_chunk=16).apply(
        params, x, ids, shift=True))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x), shift=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _flax_mair(config, sd, x):
    from tpuir.models import mair as jm

    model = jm.MaIR(embed_dim=config["embed_dim"], depths=config["depths"],
                    d_state=config["d_state"], ssm_ratio=config["ssm_ratio"],
                    mlp_ratio=config["mlp_ratio"], scan_len=config["scan_len"], scan_chunk=64)
    params = jm.convert_state_dict(_numpy_sd(sd), depths=config["depths"],
                                   embed_dim=config["embed_dim"], ssm_ratio=config["ssm_ratio"])
    return np.asarray(model.apply(params, x))


def _port_mair(config, sd, x, fused):
    net = MaIR(**config, fused=fused)
    net.load_state_dict(sd)
    with torch.inference_mode():
        y = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def _tiny_case(route, h, w):
    """(input, Flax output) of the tiny MaIR on one JAX route; the caller
    has set the route's environment."""
    x = _nhwc_input((1, h, w, 3), seed=h)
    return x, _flax_mair(TINY, init_state_dict(TINY, seed=0), x)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("h,w", [(16, 16), (24, 16)])
def test_tiny_mair_matches_flax(monkeypatch, route, fused, h, w):
    _route(monkeypatch, route)
    x, want = _tiny_case(route, h, w)
    got = _port_mair(TINY, init_state_dict(TINY, seed=0), x, fused)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_full_width_mair_matches_flax():
    """MaIR-CDN's widths (embed 180, d_inner 234, d_state 16) at depth (1,)."""
    config = dict(zoo.MAIR_CDN_CONFIG, depths=(1,))
    sd = init_state_dict(config, seed=4)
    x = _nhwc_input((1, 16, 8, 3), seed=5)
    np.testing.assert_allclose(_port_mair(config, sd, x, True), _flax_mair(config, sd, x),
                               atol=ATOL, rtol=RTOL)


def test_state_dict_round_trip_exact():
    from tpuir.models import mair as jm

    sd = init_state_dict(TINY, seed=3)
    back = state_dict_from_jax(jm.convert_state_dict(_numpy_sd(sd), depths=TINY["depths"],
                                                     embed_dim=32, ssm_ratio=1.5))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


def test_init_state_dict_released_config():
    """Seeded, loadable as it is, and the released width: 14,089,035 params."""
    sd = init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0)
    assert sum(v.numel() for v in sd.values()) == 14_089_035
    assert all(v.dtype == torch.float32 for v in sd.values())
    again = init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    MaIR(**zoo.MAIR_CDN_CONFIG).load_state_dict(sd)  # strict: every key, every shape


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_zoo_engine_matches_tpuir(monkeypatch, tmp_path):
    """The released sigma=25 config through both zoos and engines, seeded
    weights, a 40x48 request with host AWGN: within 1 uint8 LSB. Full width;
    depths cut to (2, 2) in both zoos, since full depth takes minutes on the
    CPU (chip_smoke.py holds the full-depth card path against the CPU)."""
    from tpuir import zoo as jzoo
    from tpuir.core.engine import run_model_inference as jax_run
    from tpuir.models import mair as jm

    depths = (2, 2)
    monkeypatch.setattr(zoo, "MAIR_CDN_CONFIG", dict(zoo.MAIR_CDN_CONFIG, depths=depths))
    jmair, jconvert = jm.MaIR, jm.convert_state_dict
    monkeypatch.setattr(jm, "MaIR", lambda **kw: jmair(**dict(kw, depths=depths)))
    monkeypatch.setattr(jm, "convert_state_dict",
                        lambda sd, **kw: jconvert(sd, **dict(kw, depths=depths)))
    path = tmp_path / "MaIR" / "denoising" / "MaIR_CDN_s25.pth"
    path.parent.mkdir(parents=True)
    torch.save({"params": init_state_dict(zoo.MAIR_CDN_CONFIG, seed=0)}, path)
    model = zoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=25,
                                   weights_dir=str(tmp_path), device="cpu")
    assert (model.patch_size, model.patch_overlap, model.pad_factor) == (128, 32, 8)
    jmodel = jzoo.get_model_instance("denoising", "gaussian", "MaIR", sigma=25,
                                     weights_dir=str(tmp_path))
    assert model.param_count == jmodel.param_count
    img = _image(40, 48, seed=6)
    got, _ = run_model_inference(model, img, need_degradation=True, noise_level=25)
    want, _ = jax_run(jmodel, img, need_degradation=True, noise_level=25)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("sub,sigma,precision,err", [
    ("real", None, "serving", FileNotFoundError),  # MaIRUNet serving is ported: no checkpoint
    ("gaussian", 35, "parity", ValueError),
])
def test_zoo_refuses_unported_mair(tmp_path, sub, sigma, precision, err):
    with pytest.raises(err):
        zoo.get_model_instance("denoising", sub, "MaIR", sigma=sigma, weights_dir=str(tmp_path),
                               precision=precision, device="cpu")


@pytest.mark.cuda
def test_model_kernel_path_matches_plain_on_card(cuda_device):
    """A tiny MaIR through the engine on the card: one launch of each kernel
    a block and a chunk, within 1 LSB of the plain mixers."""
    sd = init_state_dict(TINY, seed=0)
    models = []
    for fused in (True, False):
        net = MaIR(**TINY, fused=fused)
        net.load_state_dict(sd)
        models.append(InferenceModel(name="MaIR", net=net.to(cuda_device).eval(),
                                     device=cuda_device, patch_size=32, patch_overlap=8,
                                     pad_factor=8, batch_size=4))
    img = _image(45, 61, seed=7)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(models[0], img, need_degradation=True, noise_level=25)
    # 45x61 at patch 32, overlap 8: 2 x 3 tiles, chunks of 4 -> 2 forwards of 4 blocks
    for name in ("mixer_prologue", "nss_scan", "mixer_epilogue"):
        assert _kernels.LAUNCHES[name] - before[name] == 4 * 2, name
    with true_float32():
        want, _ = run_model_inference(models[1], img, need_degradation=True, noise_level=25)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
