"""The port's tiled engine and zoo against tpuir's on the CPU.

Same image, same AWGN (host MT19937), same weights: the two engines must
agree to 1 uint8 LSB. JAX is imported only on the reference side.
"""

import os

import numpy as np
import pytest
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.models.restormer import Restormer, init_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8),
            layer_norm_bias=False)
SIGMA25_REL = os.path.join("Restormer", "denoising", "gaussian_color_denoising_sigma25.pth")


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _assert_within_one_lsb(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("h,w", [(48, 64), (45, 61), (21, 29)])
def test_engine_matches_tpuir(h, w):
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.core.engine import run_model_inference as jax_run
    from tpuir.models import restormer as jres

    sd = init_state_dict(TINY, seed=0)
    hooks = dict(patch_size=32, patch_overlap=8, pad_factor=8, batch_size=4)
    jmodel = JaxInferenceModel(
        name="Restormer",
        apply_fn=jres.Restormer(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                layer_norm_bias=False).apply,
        params=jres.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                       (1, 1, 1, 1), 1, False, False),
        **hooks,
    )
    net = Restormer(**TINY, fused=True)
    net.load_state_dict(sd)
    model = InferenceModel(name="Restormer", net=net.eval(), device=torch.device("cpu"), **hooks)

    img = _image(h, w, seed=h)
    seen = []
    got, _ = run_model_inference(model, img, need_degradation=True, noise_level=25,
                                 progress_cb=lambda done, n: seen.append((done, n)))
    want, _ = jax_run(jmodel, img, need_degradation=True, noise_level=25)
    _assert_within_one_lsb(got, want)
    n = seen[-1][1]
    assert [d for d, _ in seen] == list(range(4, n, 4)) + [n]  # chunks of 4, ragged last


def test_zoo_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False, sigma=25,
                               weights_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize(
    "model_name,kw,err",
    [
        # Restormer's serving precision is ported: an absent checkpoint is what stops it
        ("Restormer", dict(precision="serving"), FileNotFoundError),
        # so is MaIRUNet's: an absent checkpoint is what stops it
        ("MaIR", dict(subtask="real", sigma=None, precision="serving"), FileNotFoundError),
        # the plain-conv families are ported: an absent checkpoint stops them
        ("DnCNN", dict(gray=True), FileNotFoundError),
        ("Restormer", dict(sigma=35), ValueError),
        ("DnCNN", dict(sigma=None), FileNotFoundError),  # color blind
        ("REDNet", dict(gray=True, sigma=50, precision="serving"), FileNotFoundError),
        ("DeblurGANv2 (MobileNet)", dict(task="deblurring", subtask="motion", sigma=None),
         FileNotFoundError),
        ("DeblurGANv2 (Inception)", dict(task="deblurring", subtask="motion", sigma=None,
                                         precision="serving"), FileNotFoundError),
        # and configurations tpuir's zoo refuses are refused
        ("DnCNN", {}, ValueError),  # color is blind-only (tpuir/zoo.py:96)
        ("REDNet", dict(gray=True, sigma=None), ValueError),
        ("DeblurGANv2", dict(task="deblurring", subtask="motion", sigma=None), ValueError),
        ("DeblurGANv2 (MobileNet)", {}, ValueError),
    ],
)
def test_zoo_refuses_what_is_not_ported(tmp_path, model_name, kw, err):
    kw = dict(dict(task="denoising", subtask="gaussian", gray=False, sigma=25,
                   weights_dir=str(tmp_path), device="cpu"), **kw)
    with pytest.raises(err):
        zoo.get_model_instance(kw.pop("task"), kw.pop("subtask"), model_name, **kw)


def test_zoo_full_width_matches_tpuir(tmp_path):
    from tpuir import zoo as jzoo
    from tpuir.core.engine import run_model_inference as jax_run

    path = tmp_path / SIGMA25_REL
    path.parent.mkdir(parents=True)
    torch.save({"params": init_state_dict(dict(layer_norm_bias=False), seed=0)}, path)

    model = zoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False, sigma=25,
                                   weights_dir=str(tmp_path), device="cpu")
    assert model.param_count == 26_111_668
    assert (model.patch_size, model.patch_overlap, model.pad_factor) == (256, 48, 8)
    assert all(blk.fused for blk in model.net.encoder_level1)
    jmodel = jzoo.get_model_instance("denoising", "gaussian", "Restormer", gray=False, sigma=25,
                                     weights_dir=str(tmp_path))

    img = _image(40, 48, seed=5)
    got, _ = run_model_inference(model, img, need_degradation=True, noise_level=25)
    want, _ = jax_run(jmodel, img, need_degradation=True, noise_level=25)
    _assert_within_one_lsb(got, want)
