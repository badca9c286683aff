"""MaIR-CDN's serving precision in the port against tpuir's on the CPU.

tpuir's side is ``MaIR(scan_io_dtype="bfloat16")`` under
``TPUIR_FUSED_INTERPRET=1``: its stripe branch, with the serving bodies of
K6, K2 and K7 in interpret mode, as ``tpuir/zoo.py`` builds it under
``precision="serving"`` with ``compute_dtype="float32"``. (Without that
variable tpuir's CPU route is its XLA branch, which sums the directions and
gates in bf16: another function.) Weights come from ``init_state_dict``,
whose output conv is scaled by 0.05 (a trained-like head). JAX is imported
only on the reference side.
"""

import functools

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.core.metrics import calculate_metrics
from tpuir_torch.models.mair import MaIR, SSMixer, init_state_dict
from tpuir_torch.models.mair_unet import MaIRUNet
from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict
from tpuir_torch.ops import _kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(embed_dim=32, depths=(2, 2), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0, scan_len=4)
HOOKS = dict(patch_size=32, patch_overlap=8, pad_factor=8, batch_size=4)
SERVING = ("mixer_prologue_serving", "nss_scan_serving", "mixer_epilogue_serving")


@functools.lru_cache(maxsize=None)
def _state_dict():
    return init_state_dict(TINY, seed=0)


@functools.lru_cache(maxsize=None)
def _tpuir(io_dtype):
    """(torch state dict, tpuir params, tpuir MaIR) of the tiny MaIR."""
    from tpuir.models import mair as jm

    sd = _state_dict()
    params = jm.convert_state_dict({k: v.numpy() for k, v in sd.items()}, depths=TINY["depths"],
                                   embed_dim=TINY["embed_dim"], ssm_ratio=TINY["ssm_ratio"])
    model = jm.MaIR(embed_dim=TINY["embed_dim"], depths=TINY["depths"], d_state=TINY["d_state"],
                    ssm_ratio=TINY["ssm_ratio"], mlp_ratio=TINY["mlp_ratio"],
                    scan_len=TINY["scan_len"], scan_chunk=64, scan_io_dtype=io_dtype)
    return sd, params, model


@functools.lru_cache(maxsize=None)
def _tpuir_outputs(h, w):
    """(input, tpuir serving, tpuir parity) of the tiny MaIR on the stripe
    branch in interpret mode; the caller has set TPUIR_FUSED_INTERPRET."""
    x = np.random.RandomState(h).rand(1, h, w, 3).astype(np.float32)
    outs = []
    for io in ("bfloat16", "float32"):
        _, params, model = _tpuir(io)
        outs.append(np.asarray(model.apply(params, x)))
    return (x, *outs)


def _port_net(serving, fused=True):
    net = MaIR(**TINY, fused=fused, serving=serving)
    net.load_state_dict(_state_dict())
    return net.eval()


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("h,w", [(16, 16), (24, 16)])
def test_tiny_mair_serving_matches_tpuir(monkeypatch, fused, h, w):
    """Nearer tpuir's serving output than tpuir's parity output is: the mean
    difference within 0.6 of the mean serving-parity gap. On the CPU the
    wrappers take their plain versions and launch nothing."""
    monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    x, want, parity = _tpuir_outputs(h, w)
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        got = _port_net(True, fused)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _kernels.LAUNCHES == before
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    gap = np.abs(want - parity).mean()
    assert gap > 0 and np.abs(got - want).mean() <= 0.6 * gap


def _clean_image(h, w, seed):
    """A smooth uint8 image: gradients and a few discs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy / h, xx / w, 0.5 + 0.5 * np.sin((xx + yy) / 7.0)], -1)
    for _ in range(3):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 4 + rng.rand() * min(h, w) / 4
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def test_engine_serving_matches_tpuir(monkeypatch):
    """Through both engines on the same noisy input (host AWGN, sigma 25),
    two 32x32 tiles: the port's serving output within 1 uint8 LSB of
    tpuir's, and its PSNR within 0.05 dB of the port's parity PSNR."""
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.core.engine import run_model_inference as jax_run

    monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    _, params, jserving = _tpuir("bfloat16")
    jmodel = JaxInferenceModel(name="MaIR", apply_fn=jserving.apply, params=params,
                               compute_dtype="float32", **HOOKS)
    cpu = torch.device("cpu")
    serving = InferenceModel(name="MaIR", net=_port_net(True), device=cpu,
                             compute_dtype="float32", **HOOKS)
    parity = InferenceModel(name="MaIR", net=_port_net(False), device=cpu, **HOOKS)
    clean = _clean_image(32, 40, seed=2)
    run = dict(need_degradation=True, noise_level=25)
    got, _ = run_model_inference(serving, clean, **run)
    want, _ = jax_run(jmodel, clean, **run)
    ref, _ = run_model_inference(parity, clean, **run)
    assert got.shape == want.shape == clean.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert abs(calculate_metrics(got, clean)[0] - calculate_metrics(ref, clean)[0]) <= 0.05


def test_zoo_serving_on_cpu(monkeypatch, tmp_path):
    """The zoo builds the released sigma=25 config at full width (depth cut
    to one group of two blocks on the CPU) with the serving mixers and a
    float32 engine boundary; on the CPU its forward is the plain serving
    path's, bit for bit, within 2 LSB of parity and 0.05 dB of its PSNR."""
    config = dict(zoo.MAIR_CDN_CONFIG, depths=(2,))
    monkeypatch.setattr(zoo, "MAIR_CDN_CONFIG", config)
    path = tmp_path / "MaIR" / "denoising" / "MaIR_CDN_s25.pth"
    path.parent.mkdir(parents=True)
    sd = init_state_dict(config, seed=0)
    torch.save({"params": sd}, path)
    kw = dict(sigma=25, weights_dir=str(tmp_path), device="cpu")
    model = zoo.get_model_instance("denoising", "gaussian", "MaIR", precision="serving", **kw)
    assert model.compute_dtype == "float32" and (model.patch_size, model.pad_factor) == (128, 8)
    mixers = [m for m in model.net.modules() if isinstance(m, SSMixer)]
    assert len(mixers) == 2 and all(m.fused and m.serving and m.nss == "stripe" for m in mixers)
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    parity = zoo.get_model_instance("denoising", "gaussian", "MaIR", precision="parity", **kw)
    assert parity.compute_dtype is None and not any(
        m.serving for m in parity.net.modules() if isinstance(m, SSMixer))

    net = MaIR(**config, fused=False, serving=True)
    net.load_state_dict(sd)
    plain = InferenceModel(name="MaIR", net=net.eval(), device=torch.device("cpu"),
                           patch_size=model.patch_size, patch_overlap=model.patch_overlap,
                           pad_factor=8, compute_dtype="float32")
    clean = _clean_image(24, 20, seed=3)
    run = dict(need_degradation=True, noise_level=25)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(model, clean, **run)
    assert _kernels.LAUNCHES == before  # the CPU takes the plain versions
    np.testing.assert_array_equal(got, run_model_inference(plain, clean, **run)[0])
    ref, _ = run_model_inference(parity, clean, **run)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2
    assert abs(calculate_metrics(got, clean)[0] - calculate_metrics(ref, clean)[0]) <= 0.05


@pytest.mark.parametrize("sub,sigma,nss,item", [
    ("real", None, None, "A3"), ("gaussian", 25, "fused", "A4"), ("gaussian", 25, "0", "A3")])
def test_zoo_refuses_unported_serving(monkeypatch, tmp_path, sub, sigma, nss, item):
    """The requests the zoo refused until ROADMAP Queue 2 ``item`` (K3's or
    K5's serving body) was ported: MaIRUNet's serving (its odd pyramid
    levels take K3) and MaIR-CDN's serving off the stripe route. Each now
    builds (depth cut to one block a stage or group on the CPU) with serving
    mixers on its route and a float32 engine boundary, and serves, on the
    CPU, the plain serving path's output bit for bit with no launch."""
    unet = sub == "real"
    key = "MAIR_UNET_CONFIG" if unet else "MAIR_CDN_CONFIG"
    cut = (dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1) if unet
           else dict(depths=(2,)))
    config = dict(getattr(zoo, key), **cut)
    monkeypatch.setattr(zoo, key, config)
    path = tmp_path / "MaIR" / "denoising" / ("MaIR_RealDN.pth" if unet else "MaIR_CDN_s25.pth")
    path.parent.mkdir(parents=True)
    sd = (unet_state_dict if unet else init_state_dict)(config, seed=0)
    torch.save({"params": sd}, path)
    model = zoo.get_model_instance("denoising", sub, "MaIR", sigma=sigma,
                                   weights_dir=str(tmp_path), precision="serving",
                                   device="cpu", nss=nss)
    mixers = [m for m in model.net.modules() if isinstance(m, SSMixer)]
    assert model.compute_dtype == "float32"
    assert mixers and all(m.fused and m.serving and m.nss == (nss or "stripe") for m in mixers)
    net = (MaIRUNet if unet else MaIR)(**config, fused=False, nss=nss or "stripe", serving=True)
    net.load_state_dict(sd)
    plain = InferenceModel(name="MaIR", net=net.eval(), device=torch.device("cpu"),
                           patch_size=model.patch_size, patch_overlap=model.patch_overlap,
                           pad_factor=8, compute_dtype="float32")
    clean = _clean_image(40, 24, seed=4) if unet else _clean_image(16, 16, seed=4)
    run = dict(need_degradation=True, noise_level=15 if unet else 25)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(model, clean, **run)
    assert _kernels.LAUNCHES == before
    np.testing.assert_array_equal(got, run_model_inference(plain, clean, **run)[0])


@pytest.mark.parametrize("nss,hw,item", [("stripe", (10, 14), "A3"), ("fused", (16, 16), "A4"),
                                         ("0", (16, 16), "A3")])
def test_serving_mixer_has_no_parity_fallback(monkeypatch, nss, hw, item):
    """A serving mixer on a level its route sends to K3 or K5 (the serving
    bodies of ROADMAP Queue 2 ``item``) calls that kernel's wrapper in its
    serving mode, never the parity body: on the CPU its output is the plain
    serving mixer's, bit for bit, with no launch, and not the parity
    mixer's."""
    from tpuir_torch.models import mair as pm

    name = "nss_scan_fused" if nss == "fused" else "selective_scan_fused_proj"
    modes = []
    fn = getattr(pm, name)

    def spy(*a, serving=False, **k):
        modes.append(serving)
        return fn(*a, serving=serving, **k)

    monkeypatch.setattr(pm, name, spy)
    mixers = {}
    for key, fused, serving in (("kernel", True, True), ("plain", False, True),
                                ("parity", True, False)):
        torch.manual_seed(0)
        mixers[key] = SSMixer(32, 4, 1.5, 4, fused=fused, nss=nss, serving=serving).eval()
        with torch.no_grad():  # scan weights as a trained mixer has them, not zeros
            for p in (mixers[key].x_proj_weight, mixers[key].dt_projs_weight):
                p.normal_(0, 0.2)
    h = torch.rand(1, *hw, 32)
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        out = {k: m(h) for k, m in mixers.items()}
    assert _kernels.LAUNCHES == before
    assert modes == [True, False]  # the serving mixer, then the parity one
    assert torch.equal(out["kernel"], out["plain"])
    assert not torch.equal(out["kernel"], out["parity"])


@pytest.mark.cuda
def test_model_serving_kernel_path_on_card():
    """A tiny serving MaIR through the engine on the card: one launch of each
    serving body a block and a chunk and none of the parity bodies, bit for
    bit on repeat, within 2 LSB of the plain serving mixers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    models = [InferenceModel(name="MaIR", net=_port_net(True, fused).to(dev), device=dev,
                             compute_dtype="float32", **HOOKS) for fused in (True, False)]
    img = _clean_image(45, 61, seed=7)
    run = dict(need_degradation=True, noise_level=25)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(models[0], img, **run)
    # 45x61 at patch 32, overlap 8: 2 x 3 tiles, chunks of 4 -> 2 forwards of 4 blocks
    for name in SERVING:
        assert _kernels.LAUNCHES[name] - before[name] == 4 * 2, name
    for name in ("mixer_prologue", "nss_scan", "mixer_epilogue"):
        assert _kernels.LAUNCHES[name] == before[name], name
    again, _ = run_model_inference(models[0], img, **run)
    want, _ = run_model_inference(models[1], img, **run)
    assert np.array_equal(got, again)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
