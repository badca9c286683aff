"""The port's DeblurGANv2 generators (FPN-MobileNet, FPN-Inception), their
train-mode norms, checkpoint reading, zoo route and harness row against
tpuir on the CPU.

Seeded torch-layout state dicts (running statistics random, since nothing
may read them) go through tpuir's ``convert_state_dict`` and ``apply`` and
through the port's ``load_checkpoint``, on the same numpy-seeded inputs in
[-1, 1]:

* ``TrainNorm`` against tpuir's, and batch-invariant (per-sample moments);
* float32 forward: atol 1e-4. FPN-MobileNet at 96x96: at 64x64 its last
  backbone stages are 2x2 maps, and per-sample moments over four values
  amplify float32 rounding differences of the convs (either side's) to
  1.2e-4 (measured, both a one-pass and a two-pass variance); at 96x96
  they are 3x3 and the difference is 2-3e-5. FPN-Inception at 160x160,
  the trunk's smallest practical input (``tests/test_fpn_inception.py``);
* ``state_dict_from_jax`` against each converter, bit for bit;
* a seeded ``.h5`` (``{'model': sd}`` with ``module.`` keys, in torch's zip
  and legacy formats) read by the port's zoo and by tpuir's own unpickler:
  the same arrays;
* through the zoo and the tiled engine: 1 uint8 LSB of tpuir's engine, and
  a CSV row (DeblurGANv2-MobileNet, GoPro) within 5e-3 dB PSNR and 1e-3
  SSIM of ``tpuir.harness.Harness``'s.

JAX is imported only on the reference side.
"""

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

from tpuir_torch import zoo
from tpuir_torch.core import image_io as pio
from tpuir_torch.core.engine import run_model_inference
from tpuir_torch.models.deblurgan import fpn_inception as pfi
from tpuir_torch.models.deblurgan import fpn_mobilenet as pfm
from tpuir_torch.models.deblurgan import norms as pnorms

ATOL = 1e-4
PSNR_DB, SSIM_TOL = 5e-3, 1e-3
TEXT = ("Task", "Type", "Dataset", "Sigma", "Model", "Model_Params")


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _module_sd(sd):
    """A released ``.h5``'s ``model``: DataParallel keys, and the original's
    extra keys (the ``fpn.enc*`` aliases of the backbone, a stage past the
    FPN's taps) that the port must ignore."""
    out = {f"module.{k}": v for k, v in sd.items()}
    out["module.fpn.enc0.0.weight"] = next(iter(sd.values()))
    out["module.fpn.unused_stage.weight"] = torch.zeros(2, 2, 1, 1)
    return out


def _forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def _signed(shape, seed):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2).astype(np.float32)


@pytest.mark.parametrize("affine,eps", [(False, 1e-5), (True, 1e-5), (True, 1e-3)])
def test_train_norm_matches_tpuir(affine, eps):
    from tpuir.models.deblurgan.norms import TrainNorm as JaxTrainNorm

    c = 6
    x = _signed((3, 9, 7, c), 0) * 3 + 0.5
    norm = pnorms.TrainNorm(c, affine=affine, eps=eps)
    params = {}
    if affine:
        rng = np.random.RandomState(1)
        w, b = (1 + 0.1 * rng.randn(c)).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)
        norm.weight.data, norm.bias.data = torch.from_numpy(w), torch.from_numpy(b)
        params = {"params": {"weight": w, "bias": b}}
    norm.running_mean.normal_()  # read by nothing
    want = np.asarray(JaxTrainNorm(c, affine=affine, eps=eps).apply(params, x))
    got = _forward(norm, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # per-sample moments: a sample alone gives what it gives in the batch
    np.testing.assert_allclose(_forward(norm, x[1:2])[0], got[1], rtol=0, atol=1e-6)


def test_train_norm_holds_the_checkpoint_statistics_unread():
    sd = {"running_mean": torch.randn(4), "running_var": torch.rand(4) + 0.5,
          "num_batches_tracked": torch.tensor(7), "weight": torch.ones(4), "bias": torch.zeros(4)}
    norm = pnorms.TrainNorm(4, affine=True)
    norm.load_state_dict(sd)
    x = torch.randn(2, 4, 5, 5)
    fresh = pnorms.TrainNorm(4, affine=True)
    assert torch.equal(norm(x), fresh(x))
    assert torch.equal(norm.running_mean, sd["running_mean"])  # loaded, untouched


def test_normalize_signed_is_tpuir_s():
    from tpuir.core.image_io import normalize_signed

    img = (np.random.RandomState(2).rand(5, 7, 3) * 255).astype(np.uint8)
    got, want = pio.normalize_signed(img), normalize_signed(img)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


GENERATORS = {  # name: (port module, port class, tpuir module, input NHWC)
    "mobilenet": (pfm, pfm.FPNMobileNet, "fpn_mobilenet", (2, 96, 96, 3)),
    "inception": (pfi, pfi.FPNInception, "fpn_inception", (1, 160, 160, 3)),
}


@pytest.fixture(scope="module", params=sorted(GENERATORS))
def gen(request):
    import importlib

    mod, cls, jname, shape = GENERATORS[request.param]
    jmod = importlib.import_module(f"tpuir.models.deblurgan.{jname}")
    sd = mod.init_state_dict(seed=3)
    net = pnorms.load_checkpoint(cls(), _module_sd(sd)).eval()
    jmodel = jmod.FPNMobileNet() if jname == "fpn_mobilenet" else jmod.FPNInception()
    params = jmod.convert_state_dict(_np(_module_sd(sd)))
    return dict(name=request.param, mod=mod, net=net, sd=sd, jmod=jmod, jmodel=jmodel,
                params=params, x=_signed(shape, 4))


def test_forward_float32_matches_tpuir(gen):
    want = np.asarray(gen["jmodel"].apply(gen["params"], gen["x"]))
    got = _forward(gen["net"], gen["x"])
    assert got.shape == want.shape == gen["x"].shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_state_dict_from_jax_inverts_the_converter(gen):
    from jax.tree_util import tree_leaves_with_path

    back = gen["mod"].state_dict_from_jax(gen["params"])
    assert back.keys() == gen["sd"].keys()
    initial = {"running_mean": 0, "running_var": 1, "num_batches_tracked": 0}
    for k, v in back.items():
        leaf = k.rsplit(".", 1)[-1]
        assert torch.equal(v, torch.full_like(v, initial[leaf]) if leaf in initial
                           else gen["sd"][k]), k
    again = dict(tree_leaves_with_path(gen["jmod"].convert_state_dict(_np(back))))
    leaves = tree_leaves_with_path(gen["params"])
    assert len(again) == len(leaves)
    for path, leaf in leaves:
        assert np.array_equal(np.asarray(again[path]), np.asarray(leaf)), path


def test_batch_invariance():
    """Each patch of a batch comes out as it does alone: the norms' moments
    are per sample (the engine batches patches freely)."""
    net = pnorms.load_checkpoint(pfm.FPNMobileNet(), pfm.init_state_dict(seed=5)).eval()
    xs = _signed((3, 64, 64, 3), 6)
    batched = _forward(net, xs)
    for i in range(3):
        np.testing.assert_allclose(batched[i], _forward(net, xs[i:i + 1])[0], rtol=0, atol=1e-5)


def test_load_checkpoint_raises_on_a_missing_parameter():
    sd = _module_sd(pfm.init_state_dict(seed=7))
    del sd["module.fpn.td1.0.bias"]
    with pytest.raises(KeyError, match="fpn.td1.0.bias"):
        pnorms.load_checkpoint(pfm.FPNMobileNet(), sd)
    sd = _module_sd(pfm.init_state_dict(seed=7))
    for k in [k for k in sd if "running" in k or "num_batches" in k]:
        del sd[k]  # statistics are never read: loading without them is fine
    pnorms.load_checkpoint(pfm.FPNMobileNet(), sd)


def _write_h5(path, sd, legacy=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": _module_sd(sd)}, path, _use_new_zipfile_serialization=not legacy)


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_h5_reads_as_tpuir_s_unpickler_reads_it(tmp_path, legacy):
    from tpuir.weights.torch_pickle import load_torch_checkpoint

    path = tmp_path / "fpn_mobilenet.h5"
    _write_h5(path, pfm.init_state_dict(seed=8), legacy)
    got = zoo._load_sd(str(path), key="model")
    want = load_torch_checkpoint(str(path))["model"]
    assert list(got) == list(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


@pytest.mark.parametrize("variant", ["MobileNet", "Inception"])
def test_zoo_routes_both_variants(tmp_path, variant):
    """The released-size generator from its ``.h5`` with the engine hooks of
    tpuir's zoo, on the requested device; the parameter count is tpuir's."""
    from tpuir.utils.misc import param_count as jax_param_count

    mod, jname = (pfm, "fpn_mobilenet") if variant == "MobileNet" else (pfi, "fpn_inception")
    sd = mod.init_state_dict(seed=9)
    _write_h5(tmp_path / "DeblurGANv2" / f"{jname}.h5", sd)
    name = f"DeblurGANv2 ({variant})"
    for precision, dtype in (("parity", None), ("serving", "float32")):
        m = zoo.get_model_instance("deblurring", "motion", name, weights_dir=str(tmp_path),
                                   precision=precision, device="cpu")
        assert (m.name, m.compute_dtype, m.pad_block, m.pad_factor) == (name, dtype, 32, None)
        assert (m.patch_size, m.patch_overlap) == ((768, 128) if variant == "Inception"
                                                   else (2048, 384))
        assert m.normalize is pio.normalize_signed
        assert torch.equal(m.postprocess(torch.tensor([-1.0, 0.0, 1.0])),
                           torch.tensor([0.0, 0.5, 1.0]))
        assert next(m.net.parameters()).device.type == "cpu"
    import importlib

    jmod = importlib.import_module(f"tpuir.models.deblurgan.{jname}")
    assert m.param_count == jax_param_count(jmod.convert_state_dict(_np(_module_sd(sd))))


def _gopro(root, shapes, seed):
    import cv2

    rng = np.random.RandomState(seed)
    mb = root / "datasets" / "deblurring" / "motion" / "test" / "GoPro"
    for sub in ("input", "target"):
        (mb / sub).mkdir(parents=True)
    for i, (h, w) in enumerate(shapes):
        target = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        blur = np.clip(target.astype(int) + rng.randint(-20, 21, target.shape), 0, 255)
        cv2.imwrite(str(mb / "target" / f"f_{i}.png"), target[..., ::-1])
        cv2.imwrite(str(mb / "input" / f"f_{i}.png"), blur.astype(np.uint8)[..., ::-1])


@pytest.mark.parametrize("precision", ["parity", "serving"])
def test_engine_matches_tpuir(tmp_path, precision):
    """FPN-MobileNet through both zoos and engines (tpuir's serving runs its
    phase-packed layout, the port the plain one: the same math): 1 LSB."""
    from tpuir import zoo as jzoo
    from tpuir.core.engine import run_model_inference as jax_run

    _write_h5(tmp_path / "DeblurGANv2" / "fpn_mobilenet.h5", pfm.init_state_dict(seed=10))
    kw = dict(weights_dir=str(tmp_path), precision=precision)
    name = "DeblurGANv2 (MobileNet)"
    model = zoo.get_model_instance("deblurring", "motion", name, device="cpu", **kw)
    jmodel = jzoo.get_model_instance("deblurring", "motion", name, **kw)
    img = (np.random.RandomState(11).rand(50, 70, 3) * 255).astype(np.uint8)
    got, _ = run_model_inference(model, img)
    want, _ = jax_run(jmodel, img)
    assert got.shape == want.shape == img.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_csv_row_deblurgan_mobilenet_matches_tpuir(tmp_path, monkeypatch):
    """The motion suite's DeblurGANv2-MobileNet cell on GoPro (two frames,
    the released generator's full width): the port's row against tpuir's."""
    from tpuir.harness import Harness as JaxHarness
    from tpuir_torch import harness as phar

    _gopro(tmp_path, [(40, 56), (48, 36)], seed=12)
    _write_h5(tmp_path / "weights" / "DeblurGANv2" / "fpn_mobilenet.h5",
              pfm.init_state_dict(seed=13))
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path / "datasets"))
    monkeypatch.delenv("TPUIR_PRECISION", raising=False)
    cell = dict(datasets=("GoPro",), models=("DeblurGANv2 (MobileNet)",))
    ours = phar.Harness(weights_dir=str(tmp_path / "weights"),
                        results_dir=str(tmp_path / "ours"), device="cpu", save_images=False)
    ours.motion_blur(**cell)
    theirs = JaxHarness(weights_dir=str(tmp_path / "weights"),
                        results_dir=str(tmp_path / "theirs"), save_images=False)
    theirs.motion_blur(**cell)
    assert len(ours.results_table) == len(theirs.results_table) == 1
    got, want = ours.results_table[0], theirs.results_table[0]
    assert {k: got[k] for k in TEXT} == {k: want[k] for k in TEXT}
    assert abs(got["PSNR"] - want["PSNR"]) <= PSNR_DB, (got["PSNR"], want["PSNR"])
    assert abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL, (got["SSIM"], want["SSIM"])
