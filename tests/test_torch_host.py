"""The port's host helpers against tpuir's, bit for bit (tpuir.core's NumPy
helpers, the patch table of tpuir.config, the host gather and blend of
tpuir.native), and the port's import boundary (no tpuir, no JAX, no Flax).

``tpuir.core`` imports JAX, so it is imported inside the tests (the
reference side) and this file still collects where JAX is absent."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpuir_torch import config
from tpuir_torch.core import degrade, image_io, metrics, native, tiling
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "h,w,ps,ov", [(512, 512, 256, 48), (481, 321, 256, 48), (200, 150, 256, 48),
                  (45, 61, 32, 8), (64, 64, None, 0)],
)
def test_tile_indices_equal(h, w, ps, ov):
    from tpuir.core import tiling as jtiling

    assert tiling.tile_indices(h, w, ps, ov) == jtiling.tile_indices(h, w, ps, ov)


@pytest.mark.parametrize("hw,c", [((256, 256), 3), ((200, 150), 1), ((33, 47), 3)])
def test_gaussian_window_equal(hw, c):
    from tpuir.core import tiling as jtiling

    got = tiling.gaussian_window(*hw, c)
    want = jtiling.gaussian_window(*hw, c)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("sigma", [15, 25, 50])
def test_add_noise_batched_equal(sigma):
    from tpuir.core import degrade as jdegrade

    patches = np.random.RandomState(sigma).rand(3, 20, 17, 3).astype(np.float32)
    got = degrade.add_noise_batched(patches, sigma)
    want = jdegrade.add_noise_batched(patches, sigma)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_normalize_and_restore_equal(dtype):
    from tpuir.core import image_io as jio

    rng = np.random.RandomState(3)
    if dtype == np.float32:
        img = (rng.rand(19, 23, 3) * 4.0).astype(np.float32)
    else:
        img = rng.randint(0, np.iinfo(dtype).max + 1, (19, 23, 3)).astype(dtype)
    got, want = image_io.normalize_image(img), jio.normalize_image(img)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    out = rng.rand(19, 23, 3).astype(np.float32) * 1.2 - 0.1
    got, want = image_io.restore_dtype(out, img), jio.restore_dtype(out, img)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape,dtype", [((40, 48, 3), np.uint8), ((40, 48, 1), np.uint8),
                                         ((33, 29, 3), np.uint16), ((30, 30), np.float32)])
def test_metrics_equal(shape, dtype):
    from tpuir.core import metrics as jmetrics

    rng = np.random.RandomState(7)
    if dtype == np.float32:
        a = rng.rand(*shape).astype(dtype)
        b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1).astype(dtype)
        rng_ = 1.0
    else:
        top = np.iinfo(dtype).max
        a = rng.randint(0, top + 1, shape).astype(dtype)
        b = np.clip(a.astype(np.int64) + rng.randint(-20, 21, shape), 0, top).astype(dtype)
        rng_ = top
    assert metrics.psnr(a, b, rng_) == jmetrics.psnr(a, b, rng_)
    a2, b2 = (a, b) if a.ndim == 2 else (a[..., 0], b[..., 0])
    assert metrics.ssim(a2, b2, rng_) == jmetrics.ssim(a2, b2, rng_)
    got, want = metrics.calculate_metrics(b, a), jmetrics.calculate_metrics(b, a)
    assert got == want and np.isfinite(got).all()


def test_patch_config_equal():
    from tpuir import config as jconfig

    assert config.PATCH_CONFIG == jconfig.PATCH_CONFIG
    assert config.ROOT_WEIGHTS_DIR == jconfig.ROOT_WEIGHTS_DIR
    for model in ("REDNet", "DnCNN", "DeblurGANv2 Inception", "DeblurGANv2 MobileNet",
                  "Restormer", "MaIR", "Nope"):
        for task, sub in (("denoising", "gaussian"), ("denoising", "real"),
                          ("deblurring", "motion"), ("deblurring", "defocus")):
            assert config.get_patch_config(task, sub, model) == \
                jconfig.get_patch_config(task, sub, model)


# the engine's tile grids of Restormer's three smoke requests (patch 256,
# overlap 48) and of a MaIR request (patch 128, overlap 32)
@pytest.mark.parametrize("h,w,ps,ov", [(512, 512, 256, 48), (481, 321, 256, 48),
                                       (200, 150, 256, 48), (256, 256, 128, 32)])
def test_gather_and_blend_equal(h, w, ps, ov):
    from tpuir import native as jnative

    rng = np.random.RandomState(h + w)
    img = rng.rand(h, w, 3).astype(np.float32)
    p, hs, ws = tiling.tile_indices(h, w, ps, ov)
    ph, pw = min(p, h), min(p, w)
    coords = [(hi, wi) for hi in hs for wi in ws]
    got = native.extract_patches(img, coords, ph, pw)
    want = jnative.extract_patches(img, coords, ph, pw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    preds = rng.rand(len(coords), ph, pw, 3).astype(np.float32)
    window = tiling.gaussian_window(p, p, 3)[:ph, :pw]
    got = native.blend_stitch(preds, coords, window, h, w)
    want = jnative.blend_stitch(preds, coords, window, h, w)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_port_imports_without_jax():
    """Every module of the port, found by walking the package (so a module
    added later is checked too), and chip_smoke import with tpuir, JAX and
    Flax blocked, optax too (the training core keeps optax's rules in
    torch.optim), gradio and matplotlib (the demo and test_demo import them
    where they draw), and cv2 and lmdb (the data stack, the augmentations
    and the scripts import them where they read, decode or write)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['tpuir'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['gradio'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['lmdb'] = None\n"
        "import tpuir_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpuir_torch.__path__, 'tpuir_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "need = {'tpuir_torch.zoo', 'tpuir_torch.models.mair_unet',\n"
        "        'tpuir_torch.ops.scan_fused_proj', 'tpuir_torch.core.engine',\n"
        "        'tpuir_torch.ops.nss_fused', 'tpuir_torch.utils.micro_rate',\n"
        "        'tpuir_torch.models.dncnn', 'tpuir_torch.models.rednet',\n"
        "        'tpuir_torch.models.deblurgan.fpn_mobilenet',\n"
        "        'tpuir_torch.models.deblurgan.fpn_inception', 'tpuir_torch.weights.caffe',\n"
        "        'tpuir_torch.demo_core', 'tpuir_torch.scripts.demo',\n"
        "        'tpuir_torch.scripts.test_demo', 'tpuir_torch.scripts.compute_flops',\n"
        "        'tpuir_torch.scripts.test_patch_size', 'tpuir_torch.scripts.validate_serving',\n"
        "        'tpuir_torch.registry', 'tpuir_torch.train.pipeline', 'tpuir_torch.train.model',\n"
        "        'tpuir_torch.ops.kernel_grad', 'tpuir_torch.scripts.train',\n"
        "        'tpuir_torch.scripts.test', 'tpuir_torch.scripts.testM',\n"
        "        'tpuir_torch.models.deblurgan.discriminators', 'tpuir_torch.train.vgg_features',\n"
        "        'tpuir_torch.train.deblurgan_losses', 'tpuir_torch.train.deblurgan_metrics',\n"
        "        'tpuir_torch.train.deblurgan_aug', 'tpuir_torch.models.deblurgan.resnet_gen',\n"
        "        'tpuir_torch.models.deblurgan.fpn_inception_simple',\n"
        "        'tpuir_torch.models.deblurgan.fpn_densenet',\n"
        "        'tpuir_torch.models.deblurgan.unet_seresnext', 'tpuir_torch.utils.matlab_resize',\n"
        "        'tpuir_torch.train.extra_metrics', 'tpuir_torch.train.fid_inception',\n"
        "        'tpuir_torch.utils.flow_io', 'tpuir_torch.train.video_datasets',\n"
        "        'tpuir_torch.utils.sidd_submission', 'tpuir_torch.scripts.make_meta_info',\n"
        "        'tpuir_torch.scripts.create_lmdb', 'tpuir_torch.parallel.dist',\n"
        "        'tpuir_torch.parallel.mesh', 'tpuir_torch.parallel.inference',\n"
        "        'tpuir_torch.parallel.collectives', 'tpuir_torch.parallel.spatial',\n"
        "        'tpuir_torch.parallel.tensor', 'tpuir_torch.parallel.train',\n"
        "        'tpuir_torch.parallel.dryrun'}\n"
        "assert need <= set(names), sorted(need - set(names))\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "(m in ('tpuir', 'jax', 'flax', 'optax', 'gradio', 'matplotlib', 'cv2', 'lmdb') or\n"
        "m.startswith(('tpuir.', 'jax.', 'flax.', 'optax.', 'gradio.', 'matplotlib.',\n"
        "'cv2.')))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 40  # every module of the port, not a few


def test_mutant_checks_share_a_process_yet_import_each_copy(tmp_path):
    """``serving_mutants.CheckWorker`` runs a check script in several copies
    of the package in one process: each run imports its own copy's modules
    (the mutation controls hold each planted copy's library), reads the
    shapes from ``sys.argv[1]``, and a failing copy gives its error and
    leaves the others' results standing."""
    from tpuir_torch.utils.serving_mutants import CheckWorker

    for name in ("a", "b"):
        pkg = tmp_path / name / "tpuir_torch" / "ops"
        pkg.mkdir(parents=True)
        (pkg.parent / "__init__.py").write_text(f"WHO = {name!r}\n")
        (pkg / "__init__.py").write_text(f"X = {name + '-ops'!r}\n")
    script = ("import json, sys\nimport tpuir_torch, tpuir_torch.ops\nprint('a build log')\n"
              "if tpuir_torch.WHO == 'b' and sys.argv[1] == '[2]':\n    raise ValueError('b')\n"
              "print(json.dumps([tpuir_torch.WHO, tpuir_torch.ops.X, json.loads(sys.argv[1])]))\n")
    copies = [("m1", str(tmp_path / "a")), ("m2", str(tmp_path / "b")), ("m3", str(tmp_path / "a"))]
    for shapes in ([1], [2]):
        worker = CheckWorker(script, shapes, str(tmp_path))
        try:
            got = [worker.check(name, d) for name, d in copies]
        finally:
            worker.close()
        assert got[0] == ("m1", ["a", "a-ops", shapes], "")
        assert got[2] == ("m3", ["a", "a-ops", shapes], "")
        if shapes == [1]:
            assert got[1] == ("m2", ["b", "b-ops", [1]], "")
        else:
            assert got[1][1] is None and "ValueError: b" in got[1][2]
