"""The port's MaIRUNet against the Flax module on the CPU, on the JAX
package's XLA route and on its Pallas route in interpret mode, with the
route each pyramid level takes; the weight carriers (state_dict_from_jax,
init_state_dict); the zoo and the tiled engine against ``tpuir``'s on a
real-denoising request; and the model's kernel path on a card.

Weights come from ``init_state_dict`` (NumPy RandomState) in the released
checkpoints' layout and reach the JAX package through its own
``convert_state_dict``. JAX is imported only on the reference side.
"""

import functools

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import InferenceModel, run_model_inference, true_float32
from tpuir_torch.models import mair as pm
from tpuir_torch.models.mair_unet import MaIRUNet, init_state_dict, state_dict_from_jax
from tpuir_torch.ops import _kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, ssm_ratio=2.0,
            flp_ratio=4.0, mlp_ratio=1.5, scan_len=4)
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
    the stripe branch (K6 -> K2 -> K7 Pallas kernels) in interpret mode on
    the levels it takes."""
    if route == "pallas":
        monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("TPUIR_FUSED_INTERPRET", raising=False)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_config(config):
    """MaIRUNet's constructor arguments under the Flax module's names."""
    cfg = dict(config)
    cfg["use_bias"] = cfg.pop("bias", False)
    return cfg


def _flax_unet(config, sd, x):
    from tpuir.models import mair_unet as ju

    cfg = _jax_config(config)
    model = ju.MaIRUNet(**cfg, scan_chunk=64)
    params = ju.convert_state_dict(
        _numpy_sd(sd), dim=cfg["dim"], num_blocks=cfg["num_blocks"],
        num_refinement_blocks=cfg["num_refinement_blocks"], ssm_ratio=cfg["ssm_ratio"],
        dual_pixel_task=cfg.get("dual_pixel_task", False))
    return np.asarray(model.apply(params, x))


def _port_unet(config, sd, x, fused=True):
    net = MaIRUNet(**config, fused=fused)
    net.load_state_dict(sd)
    with torch.inference_mode():
        y = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _nhwc_input(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tiny_case(route, h, w):
    """(input, Flax output) of the tiny MaIRUNet on one JAX route; the caller
    has set the route's environment."""
    x = _nhwc_input((1, h, w, 3), seed=h + w)
    return x, _flax_unet(TINY, init_state_dict(TINY, seed=0), x)


# 16x16: levels 16, 8, 4 on the stripe route, the 2x2 latent on K3;
# 24x40: 24x40 and 12x20 on the stripe route, 6x10 and 3x5 on K3
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("h,w", [(16, 16), (24, 40)])
def test_tiny_unet_matches_flax(monkeypatch, route, fused, h, w):
    _route(monkeypatch, route)
    x, want = _tiny_case(route, h, w)
    got = _port_unet(TINY, init_state_dict(TINY, seed=0), x, fused)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_levels_take_the_jax_routes(monkeypatch):
    """Each block's mixer goes through K2's wrapper where the JAX module
    takes its stripe kernel (H and W even multiples of scan_len) and through
    K3's elsewhere: a level on the wrong route would still agree on the CPU."""
    calls = []
    for name in ("nss_scan", "selective_scan_fused_proj"):
        fn = getattr(pm, name)

        def spy(x, *a, _name=name, _fn=fn, **k):
            hw = tuple(x.shape[1:3]) if _name == "nss_scan" else None
            calls.append((_name, hw, x.shape[-1]))
            return _fn(x, *a, **k)

        monkeypatch.setattr(pm, name, spy)
    _port_unet(TINY, init_state_dict(TINY, seed=0), _nhwc_input((1, 24, 40, 3), seed=1))
    stripe = [c for c in calls if c[0] == "nss_scan"]
    seq = [c for c in calls if c[0] == "selective_scan_fused_proj"]
    # the JAX condition (tpuir/models/mair.py:202-213) at each level of 24x40
    levels = [(24 >> i, 40 >> i) for i in range(4)]
    jax_stripe = [lv for lv in levels if lv[0] % 4 == 0 and lv[1] % 4 == 0
                  and lv[0] % 2 == 0 and lv[1] % 2 == 0]
    assert jax_stripe == [(24, 40), (12, 20)]
    # blocks: encoder 1 (24x40), encoder 2 (12x20), encoder 3 (6x10), latent
    # (3x5), decoder 3, decoder 2, decoder 1 and refinement (24x40)
    assert [c[1] for c in stripe] == [(24, 40), (12, 20), (12, 20), (24, 40), (24, 40)]
    assert [c[2] for c in stripe] == [16, 32, 32, 32, 32]  # d_inner
    assert [c[2] for c in seq] == [64, 128, 64]  # encoder 3, latent, decoder 3


def test_full_width_matches_flax():
    """MaIRUNet's released widths (dim 48, d_state 4..32) at depth (1,1,1,1),
    refinement 1, on a 16x24 input: two levels on K2, two on K3."""
    config = dict(zoo.MAIR_UNET_CONFIG, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    sd = init_state_dict(config, seed=4)
    x = _nhwc_input((1, 16, 24, 3), seed=5)
    np.testing.assert_allclose(_port_unet(config, sd, x), _flax_unet(config, sd, x),
                               atol=ATOL, rtol=RTOL)


def test_dual_pixel_matches_flax():
    """The dual-pixel branch (6 input channels, skip_conv, no input residual)
    as the JAX module has it."""
    config = dict(TINY, inp_channels=6, dual_pixel_task=True)
    sd = init_state_dict(config, seed=6)
    assert "skip_conv.weight" in sd
    x = _nhwc_input((1, 16, 16, 6), seed=7)
    np.testing.assert_allclose(_port_unet(config, sd, x), _flax_unet(config, sd, x),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dual", [False, True])
def test_state_dict_round_trip_exact(dual):
    from tpuir.models import mair_unet as ju

    config = dict(TINY, inp_channels=6 if dual else 3, dual_pixel_task=dual)
    sd = init_state_dict(config, seed=3)
    back = state_dict_from_jax(ju.convert_state_dict(
        _numpy_sd(sd), dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
        ssm_ratio=2.0, dual_pixel_task=dual))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


def test_init_state_dict_released_config():
    """Seeded, loadable as it is, and the released width: 26,293,296 params
    (the count ``jax.eval_shape`` gives the Flax module)."""
    sd = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0)
    assert sum(v.numel() for v in sd.values()) == 26_293_296
    assert all(v.dtype == torch.float32 for v in sd.values())
    again = init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    MaIRUNet(**zoo.MAIR_UNET_CONFIG).load_state_dict(sd)  # strict: every key, every shape


def _noisy_image(h, w, seed):
    rng = np.random.RandomState(seed)
    clean = rng.rand(h, w, 3) * 200 + 20
    return np.clip(np.round(clean + rng.randn(h, w, 3) * 15), 0, 255).astype(np.uint8)


def _cut_depth(monkeypatch, num_blocks, refinement):
    """Cut MaIRUNet's depth in both zoos (full width)."""
    from tpuir.models import mair_unet as ju

    monkeypatch.setattr(zoo, "MAIR_UNET_CONFIG", dict(
        zoo.MAIR_UNET_CONFIG, num_blocks=num_blocks, num_refinement_blocks=refinement))
    cut = dict(num_blocks=num_blocks, num_refinement_blocks=refinement)
    junet, jconvert = ju.MaIRUNet, ju.convert_state_dict
    monkeypatch.setattr(ju, "MaIRUNet", lambda **kw: junet(**dict(kw, **cut)))
    monkeypatch.setattr(ju, "convert_state_dict", lambda sd, **kw: jconvert(sd, **dict(kw, **cut)))


@pytest.mark.parametrize("task,sub,rel", [
    ("denoising", "real", "denoising/MaIR_RealDN.pth"),
    ("deblurring", "motion", "deblurring/MaIR_MotionDeblur.pth"),
])
def test_zoo_engine_matches_tpuir(monkeypatch, tmp_path, task, sub, rel):
    """The released MaIRUNet configs through both zoos and engines, seeded
    weights, a 40x56 noisy request served as it is (no degradation): within
    1 uint8 LSB. Full width; depth cut to (1, 1, 1, 1) with refinement 1 in
    both zoos, since full depth takes minutes on the CPU (chip_smoke.py holds
    the full-depth card path against the CPU). Levels 10x14 and 5x7 take K3."""
    from tpuir import zoo as jzoo
    from tpuir.core.engine import run_model_inference as jax_run

    _cut_depth(monkeypatch, (1, 1, 1, 1), 1)
    path = tmp_path / "MaIR" / rel
    path.parent.mkdir(parents=True)
    torch.save({"params": init_state_dict(zoo.MAIR_UNET_CONFIG, seed=0)}, path)
    model = zoo.get_model_instance(task, sub, "MaIR", weights_dir=str(tmp_path), device="cpu")
    assert isinstance(model.net, MaIRUNet) and model.net.encoder_level1[0].self_attention.fused
    assert (model.patch_size, model.patch_overlap, model.pad_factor) == (384, 128, 8)
    jmodel = jzoo.get_model_instance(task, sub, "MaIR", weights_dir=str(tmp_path))
    assert model.param_count == jmodel.param_count
    img = _noisy_image(40, 56, seed=8)
    got, _ = run_model_inference(model, img, need_degradation=False)
    want, _ = jax_run(jmodel, img, need_degradation=False)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.cuda
def test_model_kernel_path_matches_plain_on_card(cuda_device):
    """A tiny MaIRUNet through the engine on the card: 40x56 tiles pad to
    40x56, whose levels 40x56 and 20x28 take K6 -> K2 -> K7 (5 blocks) and
    10x14 and 5x7 take K3 (3 blocks); within 1 LSB of the plain path."""
    sd = init_state_dict(TINY, seed=0)
    models = []
    for fused in (True, False):
        net = MaIRUNet(**TINY, fused=fused)
        net.load_state_dict(sd)
        models.append(InferenceModel(name="MaIR", net=net.to(cuda_device).eval(),
                                     device=cuda_device, patch_size=40, patch_overlap=8,
                                     pad_factor=8, batch_size=4))
    img = _noisy_image(40, 120, seed=9)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(models[0], img)
    again, _ = run_model_inference(models[0], img)
    # 40x120 at patch 40, overlap 8: 1 x 4 tiles, one chunk of 4, twice
    for name, n in (("mixer_prologue", 5), ("nss_scan", 5), ("mixer_epilogue", 5),
                    ("selective_scan_fused_proj", 3)):
        assert _kernels.LAUNCHES[name] - before[name] == 2 * n, name
    assert np.array_equal(got, again)
    with true_float32():
        want, _ = run_model_inference(models[1], img)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
