"""MaIR's serving precision off the stripe route in the port against tpuir's
on the CPU: MaIRUNet (whose odd pyramid levels take the sequence route, K3)
and MaIR-CDN under ``nss="fused"`` (K5) and ``nss="0"`` (K3 on every
level), at model level and through both engines; and the zoo's serving
MaIRUNet.

tpuir's side is its modules with ``scan_io_dtype="bfloat16"`` under
``TPUIR_FUSED_INTERPRET=1``, and for the sequence route with K3 routed in:
its mixer takes K3 only off the CPU (``tpuir/models/mair.py:351``), and its
CPU branch there is another function (it rounds xs, but not W_xp, W_dt or
the dt columns). So the fixture ``tpuir_k3`` makes that test's
``jax.default_backend`` answer "tpu" and runs tpuir's
``selective_scan_fused_proj`` in interpret mode, through ``monkeypatch``;
nothing in the JAX package changes, and no other test sees it. Model-level
references are tpuir's eager ``apply`` (its jitted program, which the JAX
engine runs, rounds at other places). Weights come from
``init_state_dict``; JAX is imported only on the reference side.
"""

import functools

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.core.metrics import calculate_metrics
from tpuir_torch.models.mair import MaIR, SSMixer
from tpuir_torch.models.mair import init_state_dict as mair_state_dict
from tpuir_torch.models.mair_unet import MaIRUNet
from tpuir_torch.models.mair_unet import init_state_dict as unet_state_dict
from tpuir_torch.ops import _kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

UNET = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, ssm_ratio=2.0,
            flp_ratio=4.0, mlp_ratio=1.5, scan_len=4)
MAIR = dict(embed_dim=32, depths=(2, 2), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0, scan_len=4)
# (model, H, W, nss): MaIRUNet at 40x24 takes the sequence route at 10x6 and
# 5x3 (K3, d_state 16 and 32) and the stripe route above; MaIR-CDN at 16x16
# takes K5 under "fused" and K3 under "0" in every block
CASES = {"unet": ("unet", 40, 24, "stripe"), "mair-fused": ("mair", 16, 16, "fused"),
         "mair-0": ("mair", 16, 16, "0")}
GAP_SHARE = 0.35  # mean |port - tpuir| as a share of the mean |tpuir serving - parity|


@pytest.fixture
def tpuir_k3(monkeypatch):
    """tpuir's serving and parity routes in interpret mode on the CPU, its
    sequence route through K3 (see the module docstring)."""
    import jax

    from tpuir.ops import scan_pallas

    monkeypatch.setenv("TPUIR_FUSED_INTERPRET", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(scan_pallas, "selective_scan_fused_proj",
                        functools.partial(scan_pallas.selective_scan_fused_proj, interpret=True))
    return monkeypatch


@functools.lru_cache(maxsize=None)
def _state_dict(model):
    return unet_state_dict(UNET, seed=0) if model == "unet" else mair_state_dict(MAIR, seed=0)


def _tpuir_model(model, io_dtype):
    """(tpuir params, tpuir module) of a tiny model."""
    sd = {k: v.numpy() for k, v in _state_dict(model).items()}
    if model == "unet":
        from tpuir.models import mair_unet as ju

        cfg = dict(UNET, use_bias=False)
        params = ju.convert_state_dict(sd, dim=UNET["dim"], num_blocks=UNET["num_blocks"],
                                       num_refinement_blocks=UNET["num_refinement_blocks"],
                                       ssm_ratio=UNET["ssm_ratio"], dual_pixel_task=False)
        return params, ju.MaIRUNet(**cfg, scan_chunk=64, scan_io_dtype=io_dtype)
    from tpuir.models import mair as jm

    params = jm.convert_state_dict(sd, depths=MAIR["depths"], embed_dim=MAIR["embed_dim"],
                                   ssm_ratio=MAIR["ssm_ratio"])
    return params, jm.MaIR(**MAIR, scan_chunk=64, scan_io_dtype=io_dtype)


def _clean_image(h, w, seed):
    """A smooth uint8 image: gradients and a few discs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy / h, xx / w, 0.5 + 0.5 * np.sin((xx + yy) / 7.0)], -1)
    for _ in range(3):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 4 + rng.rand() * min(h, w) / 4
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _tpuir_outputs(case):
    """(input, tpuir serving, tpuir parity) of a case's model (eager apply);
    the caller has set up ``tpuir_k3`` and the case's TPUIR_NSS."""
    model, h, w, _ = CASES[case]
    x = np.random.RandomState(h + w).rand(1, h, w, 3).astype(np.float32)
    outs = []
    for io in ("bfloat16", "float32"):
        params, module = _tpuir_model(model, io)
        outs.append(np.asarray(module.apply(params, x)))
    return (x, *outs)


def _port_net(model, nss, serving, fused=True):
    cls, cfg = (MaIRUNet, UNET) if model == "unet" else (MaIR, MAIR)
    net = cls(**cfg, fused=fused, nss=nss, serving=serving)
    net.load_state_dict(_state_dict(model))
    return net.eval()


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiny_serving_matches_tpuir(tpuir_k3, case, fused):
    """The mean |port serving - tpuir serving| within 0.35 of the mean
    |tpuir serving - tpuir parity|, a bound that tpuir's CPU sequence
    branch and a SiLU rounded once instead of per operation each miss. On
    the CPU the wrappers take their plain versions and launch nothing."""
    model, _, _, nss = CASES[case]
    tpuir_k3.setenv("TPUIR_NSS", nss)
    x, want, parity = _tpuir_outputs(case)
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        got = _port_net(model, nss, True, fused)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _kernels.LAUNCHES == before
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    gap = np.abs(want - parity).mean()
    assert gap > 0 and np.abs(got - want).mean() <= GAP_SHARE * gap, (
        np.abs(got - want).mean() / gap)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_serving_matches_tpuir(tpuir_k3, case):
    """Through both engines on the same noisy input served as it is, one
    tile: the port's serving output within 1 uint8 LSB of tpuir's (its
    jitted engine), and its PSNR within 0.05 dB of the port's parity PSNR."""
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.core.engine import run_model_inference as jax_run

    model, h, w, nss = CASES[case]
    tpuir_k3.setenv("TPUIR_NSS", nss)
    hooks = dict(patch_size=max(h, w), patch_overlap=8, pad_factor=8, batch_size=1)
    params, module = _tpuir_model(model, "bfloat16")
    jmodel = JaxInferenceModel(name="MaIR", apply_fn=module.apply, params=params,
                               compute_dtype="float32", **hooks)
    cpu = torch.device("cpu")
    serving = InferenceModel(name="MaIR", net=_port_net(model, nss, True), device=cpu,
                             compute_dtype="float32", **hooks)
    parity = InferenceModel(name="MaIR", net=_port_net(model, nss, False), device=cpu, **hooks)
    clean = _clean_image(h, w, seed=h * w)
    noisy = np.clip(np.round(clean + np.random.RandomState(1).randn(*clean.shape) * 15), 0,
                    255).astype(np.uint8)
    run = dict(need_degradation=False)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(serving, noisy, **run)
    assert _kernels.LAUNCHES == before
    want, _ = jax_run(jmodel, noisy, **run)
    ref, _ = run_model_inference(parity, noisy, **run)
    assert got.shape == want.shape == clean.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert abs(calculate_metrics(got, clean)[0] - calculate_metrics(ref, clean)[0]) <= 0.05


def test_zoo_serving_unet_on_cpu(monkeypatch, tmp_path):
    """The zoo builds the released real-denoising MaIRUNet at full width
    (depth cut to one block a stage on the CPU) with serving mixers and a
    float32 engine boundary; on the CPU its forward is the plain serving
    path's, bit for bit, launches nothing, and lies within 2 LSB of parity
    and 0.05 dB of its PSNR on a request whose two deepest levels take K3."""
    config = dict(zoo.MAIR_UNET_CONFIG, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
    monkeypatch.setattr(zoo, "MAIR_UNET_CONFIG", config)
    path = tmp_path / "MaIR" / "denoising" / "MaIR_RealDN.pth"
    path.parent.mkdir(parents=True)
    sd = unet_state_dict(config, seed=0)
    torch.save({"params": sd}, path)
    kw = dict(weights_dir=str(tmp_path), device="cpu")
    model = zoo.get_model_instance("denoising", "real", "MaIR", precision="serving", **kw)
    assert model.compute_dtype == "float32" and (model.patch_size, model.pad_factor) == (384, 8)
    mixers = [m for m in model.net.modules() if isinstance(m, SSMixer)]
    assert len(mixers) == 8 and all(m.fused and m.serving and m.nss == "stripe" for m in mixers)
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    parity = zoo.get_model_instance("denoising", "real", "MaIR", precision="parity", **kw)
    assert parity.compute_dtype is None and not any(
        m.serving for m in parity.net.modules() if isinstance(m, SSMixer))

    net = MaIRUNet(**config, fused=False, serving=True)
    net.load_state_dict(sd)
    plain = InferenceModel(name="MaIR", net=net.eval(), device=torch.device("cpu"),
                           patch_size=model.patch_size, patch_overlap=model.patch_overlap,
                           pad_factor=8, compute_dtype="float32")
    # 40x24: levels 40x24 and 20x12 on the stripe route, 10x6 and 5x3 on K3
    assert [mixers[0].route(40 >> i, 24 >> i) for i in range(4)] == [
        "stripe", "stripe", "sequence", "sequence"]
    clean = _clean_image(40, 24, seed=5)
    run = dict(need_degradation=True, noise_level=15)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(model, clean, **run)
    assert _kernels.LAUNCHES == before  # the CPU takes the plain versions
    np.testing.assert_array_equal(got, run_model_inference(plain, clean, **run)[0])
    ref, _ = run_model_inference(parity, clean, **run)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2
    assert abs(calculate_metrics(got, clean)[0] - calculate_metrics(ref, clean)[0]) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_serving_kernel_paths_on_card(case):
    """A tiny serving model through the engine on the card, one tile: each
    level's serving body launched once a block and no parity body, bit for
    bit on repeat, within 2 LSB of the plain serving mixers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    model, h, w, nss = CASES[case]
    dev = torch.device("cuda")
    hooks = dict(patch_size=max(h, w), patch_overlap=8, pad_factor=8, batch_size=1)
    models = [InferenceModel(name="MaIR", net=_port_net(model, nss, True, fused).to(dev),
                             device=dev, compute_dtype="float32", **hooks)
              for fused in (True, False)]
    img = _clean_image(h, w, seed=7)
    run = dict(need_degradation=True, noise_level=15)
    before = dict(_kernels.LAUNCHES)
    got, _ = run_model_inference(models[0], img, **run)
    launched = {k: n - before[k] for k, n in _kernels.LAUNCHES.items() if n != before[k]}
    want = {"unet": {"mixer_prologue_serving": 5, "nss_scan_serving": 5,
                     "mixer_epilogue_serving": 5, "selective_scan_fused_proj_serving": 3},
            "mair-fused": {"nss_scan_fused_serving": 4},
            "mair-0": {"selective_scan_fused_proj_serving": 4}}[case]
    assert launched == want
    again, _ = run_model_inference(models[0], img, **run)
    plain, _ = run_model_inference(models[1], img, **run)
    assert np.array_equal(got, again)
    assert np.abs(got.astype(int) - plain.astype(int)).max() <= 2
