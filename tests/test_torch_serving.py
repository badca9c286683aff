"""Restormer's serving precision in the port against tpuir's on the CPU.

tpuir's side is ``restormer_fused`` with ``mm_bf16=True, io_bf16=True,
fast_gelu=True`` (its blocks in interpret mode), as ``tpuir/zoo.py`` builds
it under ``precision="serving"`` and ``scripts/validate_serving.py`` builds
its bundle, with ``compute_dtype="float32"``. Weights come from
``init_state_dict``, whose output conv is scaled by 0.05 (a trained-like
head, as ``validate_serving.py``'s ``_scale_head`` makes one). JAX is
imported only on the reference side.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.core.metrics import calculate_metrics
from tpuir_torch.models.restormer import Restormer, init_state_dict
from tpuir_torch.ops import _kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8))
HOOKS = dict(patch_size=32, patch_overlap=8, pad_factor=8, batch_size=4)
SIGMA25_REL = os.path.join("Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")


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
def _tpuir(ln_bias, dual=False):
    """(torch state dict, tpuir params, tpuir apply_fn for parity and serving)
    of the tiny Restormer, dual-pixel (6 input channels) or not."""
    from tpuir.models import restormer as jres
    from tpuir.models import restormer_fused

    config = dict(TINY, layer_norm_bias=ln_bias)
    if dual:
        config.update(inp_channels=6, dual_pixel_task=True)
    sd = init_state_dict(config, seed=0)
    params = jres.convert_state_dict({k: v.numpy() for k, v in sd.items()}, TINY["num_blocks"],
                                     TINY["num_refinement_blocks"], False, ln_bias, dual)
    cfg = dict(num_blocks=TINY["num_blocks"], heads=TINY["heads"],
               num_refinement_blocks=TINY["num_refinement_blocks"], dual_pixel_task=dual,
               interpret=True)
    parity = restormer_fused.make_apply_fn(ln_bias=ln_bias, **cfg)
    serving = restormer_fused.make_apply_fn(ln_bias=ln_bias, mm_bf16=True, row_tile=16,
                                            io_bf16=True, fast_gelu=True, **cfg)
    return sd, params, parity, serving


def _port_net(sd, ln_bias, serving, dual=False):
    net = Restormer(**TINY, layer_norm_bias=ln_bias, fused=True, serving=serving,
                    **(dict(inp_channels=6, dual_pixel_task=True) if dual else {}))
    net.load_state_dict(sd)
    return net.eval()


def _model_level(ln_bias, dual):
    """(port serving, tpuir serving, mean |tpuir serving - tpuir parity|) of
    the tiny Restormer on one seeded input."""
    import jax.numpy as jnp

    sd, params, jparity, jserving = _tpuir(ln_bias, dual)
    x = np.random.RandomState(1).rand(1, 32, 24, 6 if dual else 3).astype(np.float32)
    want = np.asarray(jserving(params, jnp.asarray(x)))
    gap = np.abs(want - np.asarray(jparity(params, jnp.asarray(x)))).mean()
    before = _kernels.LAUNCHES["fused_transformer_block_serving"]
    with torch.inference_mode():
        got = _port_net(sd, ln_bias, True, dual)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _kernels.LAUNCHES["fused_transformer_block_serving"] == before
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    return got, want, gap


@pytest.mark.parametrize("ln_bias", [False, True])
def test_tiny_restormer_serving_matches_tpuir(ln_bias):
    got, want, gap = _model_level(ln_bias, False)
    assert np.abs(got - want).mean() <= 0.6 * gap


def test_tiny_dual_pixel_serving_matches_tpuir():
    """The dual-pixel head (skip_conv added in bf16 before the output conv,
    no input residual): nearer tpuir's serving output than tpuir's parity
    output is, and within half a uint8 LSB of it."""
    got, want, gap = _model_level(True, True)
    assert np.abs(got - want).mean() <= gap
    assert np.abs(got - want).max() <= 0.5 / 255


@pytest.mark.parametrize("ln_bias", [False, True])
def test_engine_serving_matches_tpuir(ln_bias):
    """Through both engines on the same noisy input (host AWGN, sigma 25):
    the port's serving output within 2 uint8 LSB of tpuir's, and its PSNR
    within 0.05 dB of the port's parity PSNR."""
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.core.engine import run_model_inference as jax_run

    sd, params, _, jserving = _tpuir(ln_bias)
    jmodel = JaxInferenceModel(name="Restormer", apply_fn=jserving, params=params,
                               compute_dtype="float32", **HOOKS)
    cpu = torch.device("cpu")
    serving = InferenceModel(name="Restormer", net=_port_net(sd, ln_bias, True), device=cpu,
                             compute_dtype="float32", **HOOKS)
    parity = InferenceModel(name="Restormer", net=_port_net(sd, ln_bias, False), device=cpu,
                            **HOOKS)
    clean = _clean_image(40, 48, seed=2)
    run = dict(need_degradation=True, noise_level=25)
    got, _ = run_model_inference(serving, clean, **run)
    want, _ = jax_run(jmodel, clean, **run)
    ref, _ = run_model_inference(parity, clean, **run)
    assert got.shape == want.shape == clean.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    assert abs(calculate_metrics(got, clean)[0] - calculate_metrics(ref, clean)[0]) <= 0.05


def test_zoo_serving_on_cpu(tmp_path):
    """The zoo builds the released sigma=25 config at full width with
    serving blocks and a float32 engine boundary; on the CPU its forward is
    the plain serving path's, bit for bit, and within 2 LSB of parity."""
    path = tmp_path / SIGMA25_REL
    path.parent.mkdir(parents=True)
    sd = init_state_dict(dict(layer_norm_bias=False), seed=0)
    torch.save({"params": sd}, path)
    kw = dict(gray=False, sigma=25, weights_dir=str(tmp_path), device="cpu")
    model = zoo.get_model_instance("denoising", "gaussian", "Restormer", precision="serving", **kw)
    assert model.compute_dtype == "float32" and model.param_count == 26_111_668
    assert model.net.serving and all(b.fused and b.serving for b in model.net.refinement)
    parity = zoo.get_model_instance("denoising", "gaussian", "Restormer", precision="parity", **kw)
    assert parity.compute_dtype is None and not parity.net.serving

    net = Restormer(layer_norm_bias=False, serving=True)
    net.load_state_dict(sd)
    plain = InferenceModel(name="Restormer", net=net.eval(), device=torch.device("cpu"),
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


class _Spy(torch.nn.Module):
    """Records the dtype and the TF32 settings a forward sees; returns x * 2."""

    def forward(self, x):
        self.seen = (x.dtype, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        return x * 2


@pytest.mark.parametrize("compute_dtype,dtype,pinned", [
    (None, torch.float32, True), ("float32", torch.float32, False),
    ("bfloat16", torch.bfloat16, False)])
def test_engine_compute_dtype(compute_dtype, dtype, pinned):
    """None pins true float32 (TF32 off) around the forward; "float32" leaves
    PyTorch's settings; "bfloat16" also casts the chunk; the output is
    float32 in every mode."""
    spy = _Spy()
    model = InferenceModel(name="spy", net=spy, device=torch.device("cpu"),
                           compute_dtype=compute_dtype)
    x = torch.rand(2, 3, 8, 8)
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    y = model.step(x)
    assert spy.seen == ((dtype, False, False) if pinned else (dtype,) + defaults)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, (x.to(dtype) * 2).float(), atol=0, rtol=0)
    with pytest.raises(ValueError):
        InferenceModel(name="spy", net=spy, device=torch.device("cpu"), compute_dtype="half")


def test_resolve_precision_reads_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("TPUIR_PRECISION", raising=False)
    assert zoo.resolve_precision() == "parity"
    monkeypatch.setenv("TPUIR_PRECISION", "serving")
    assert zoo.resolve_precision() == "serving"
    assert zoo.resolve_precision("parity") == "parity"  # an argument wins
    path = tmp_path / SIGMA25_REL
    path.parent.mkdir(parents=True)
    torch.save({"params": init_state_dict(dict(layer_norm_bias=False), seed=0)}, path)
    model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False, sigma=25,
                                   weights_dir=str(tmp_path), device="cpu")
    assert model.net.serving and model.compute_dtype == "float32"
    monkeypatch.setenv("TPUIR_PRECISION", "bf16")
    with pytest.raises(ValueError):
        zoo.resolve_precision()
