"""The port's DnCNN and REDNet, its caffemodel reader and their zoo and
harness routes against tpuir on the CPU.

Seeded torch-layout state dicts go through tpuir's ``convert_state_dict``
and ``apply`` and through the port's ``load_state_dict``, on the same
numpy-seeded inputs:

* float32 forward: atol 1e-4 (the ROADMAP's model tolerance);
* serving (a bf16 input, float32 convs, the residual taken in bf16, as
  both zoos serve these two families): each output element within one bf16
  ulp of tpuir's at that element's magnitude (2^-7 of the power of two at
  or below it), since a float32 rounding difference in the conv stack may
  flip the residual's one bf16 rounding;
* ``state_dict_from_jax`` against each converter, bit for bit both ways;
* the port's copy of tpuir's caffemodel reader bit-equal to tpuir's on the
  synthetic caffemodels of ``tests/test_caffe.py`` and on a REDNet file
  written by the port's ``write_caffemodel``;
* through the zoo and the tiled engine: 1 uint8 LSB of tpuir's engine; a
  CSV row (DnCNN sigma=25 gray, Set12) within 5e-3 dB PSNR and 1e-3 SSIM
  of ``tpuir.harness.Harness``'s (``tests/test_torch_harness.py``'s
  protocol).

JAX is imported only on the reference side.
"""

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

from tpuir_torch import zoo
from tpuir_torch.core.engine import run_model_inference
from tpuir_torch.models import dncnn as pdncnn
from tpuir_torch.models import rednet as prednet
from tpuir_torch.weights import caffe as pcaffe

ATOL = 1e-4
PSNR_DB, SSIM_TOL = 5e-3, 1e-3
TEXT = ("Task", "Type", "Dataset", "Sigma", "Model", "Model_Params")


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _bf16(x):
    """numpy float32 -> a bf16 tensor (round to nearest even), NHWC kept."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _within_one_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def _within_one_lsb(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


CASES = {  # name: (port module, port net, (tpuir model, its converter), seeded sd, input NHWC)
    "dncnn": lambda: (pdncnn, pdncnn.DnCNN(1, 1, 64, 5), _jax_dncnn(5),
                      pdncnn.init_state_dict(1, 5, seed=0), (2, 24, 28, 1)),
    "dncnn_color": lambda: (pdncnn, pdncnn.DnCNN(3, 3, 64, 4), _jax_dncnn(4, 3),
                            pdncnn.init_state_dict(3, 4, seed=1), (1, 20, 18, 3)),
    "rednet": lambda: (prednet, prednet.REDNet(1, 16), _jax_rednet(16),
                       prednet.init_state_dict(1, 16, seed=2), (2, 22, 26, 1)),
}


def _jax_dncnn(nb, nc=1):
    from tpuir.models import dncnn as jd

    return jd.DnCNN(in_nc=nc, out_nc=nc, nc=64, nb=nb), lambda sd: jd.convert_state_dict(sd, nb)


def _jax_rednet(nf):
    from tpuir.models import rednet as jr

    return jr.REDNet(num_channels=1, num_features=nf), jr.convert_state_dict


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    mod, net, (jmodel, jconvert), sd, shape = CASES[request.param]()
    net.load_state_dict(sd)
    x = np.random.RandomState(len(request.param)).rand(*shape).astype(np.float32)
    return dict(mod=mod, net=net.eval(), jmodel=jmodel, params=jconvert(_np(sd)), sd=sd, x=x)


def test_forward_float32_matches_tpuir(case):
    want = np.asarray(case["jmodel"].apply(case["params"], case["x"]))
    with torch.no_grad():
        got = _nhwc(case["net"](_nchw(case["x"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_serving_forward_matches_tpuir(case):
    """bf16 in, bf16 out: the engine's ``compute_dtype="bfloat16"`` chunk."""
    import jax.numpy as jnp

    xb = _bf16(case["x"])
    want = case["jmodel"].apply(case["params"], jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = case["net"](xb.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(_nhwc(got), np.asarray(want, np.float32))


def test_state_dict_from_jax_inverts_the_converter(case):
    back = case["mod"].state_dict_from_jax(case["params"])
    assert back.keys() == case["sd"].keys()
    assert all(torch.equal(back[k], case["sd"][k]) for k in back)
    # and the converter reads it back to the same params, bit for bit
    from jax.tree_util import tree_leaves_with_path

    again = dict(tree_leaves_with_path(_jax_convert(case)(_np(back))))
    for path, leaf in tree_leaves_with_path(case["params"]):
        assert np.array_equal(np.asarray(again[path]), np.asarray(leaf)), path


def _jax_convert(case):
    from tpuir.models import dncnn as jd
    from tpuir.models import rednet as jr

    if case["mod"] is prednet:
        return jr.convert_state_dict
    return lambda sd: jd.convert_state_dict(sd, len(case["params"]["params"]))


# -- the caffemodel reader ----------------------------------------------------


def _synthetic_caffemodels(tmp_path):
    from tests import test_caffe as tc

    w = np.random.RandomState(0).randn(4, 3, 3, 3).astype(np.float32)
    b = np.random.RandomState(1).randn(4).astype(np.float32)
    new = (tc._len_field(1, b"conv1") + tc._len_field(2, b"Convolution")
           + tc._len_field(7, tc._blob_new(w)) + tc._len_field(7, tc._blob_new(b)))
    blob, _ = tc._blob_old((2, 3, 3, 3))
    bias, _ = tc._blob_old((1, 1, 1, 2))
    old = (tc._len_field(4, b"deconv1") + tc._tag(5, 0) + tc._varint(39)
           + tc._len_field(6, blob) + tc._len_field(6, bias))
    junk = (tc._tag(3, 0) + tc._varint(7) + tc._len_field(50, b"junkjunk")
            + tc._len_field(100, tc._len_field(1, b"c")
                            + tc._len_field(7, tc._blob_new(np.ones((1, 1, 1, 1), np.float32)))))
    files = {"new": tc._len_field(1, b"rednet") + tc._len_field(100, new),
             "old": tc._len_field(2, old), "junk": junk}
    paths = []
    for name, data in files.items():
        (tmp_path / f"{name}.caffemodel").write_bytes(data)
        paths.append(str(tmp_path / f"{name}.caffemodel"))
    rn = tmp_path / "rednet.caffemodel"
    pcaffe.write_caffemodel(str(rn), _np(prednet.init_state_dict(1, 8, seed=3)))
    return paths + [str(rn)]


def _same_arrays(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
        else:
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def test_caffe_copy_is_bit_equal_to_tpuir(tmp_path):
    from tpuir.weights import caffe as jcaffe

    for path in _synthetic_caffemodels(tmp_path):
        _same_arrays(pcaffe.read_caffemodel(path), jcaffe.read_caffemodel(path))
        _same_arrays(pcaffe.caffemodel_to_state_dict(path), jcaffe.caffemodel_to_state_dict(path))


def test_write_caffemodel_round_trips_rednet_blobs(tmp_path):
    """Deconv blobs keep the transposed conv's (in, out, kh, kw) layout, so
    the written file loads into ``REDNet`` as it is."""
    sd = prednet.init_state_dict(1, 8, seed=4)
    path = str(tmp_path / "r.caffemodel")
    pcaffe.write_caffemodel(path, _np(sd))
    back = pcaffe.caffemodel_to_state_dict(path)
    assert list(back) == list(sd)
    assert all(np.array_equal(back[k], sd[k].numpy()) for k in sd)
    assert back["deconv1.weight"].shape == (8, 8, 3, 3) and back["deconv15.weight"].shape[1] == 1
    prednet.REDNet(1, 8).load_state_dict({k: torch.from_numpy(v) for k, v in back.items()})


# -- the zoo, the engine and the harness --------------------------------------


def _write_dncnn(wdir, fname, nc, nb, seed):
    path = wdir / "DnCNN" / fname
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(pdncnn.init_state_dict(nc, nb, seed=seed), path)


def _write_rednet(wdir, sigma, seed, caffemodel=False):
    d = wdir / "REDNet"
    d.mkdir(parents=True, exist_ok=True)
    sd = prednet.init_state_dict(1, 128, seed=seed)
    if caffemodel:
        pcaffe.write_caffemodel(str(d / f"{sigma}.caffemodel"), _np(sd))
    else:
        torch.save(sd, d / f"{sigma}.pt")


DNCNN_CONFIGS = [  # (gray, sigma, file, channels, depth): tpuir/zoo.py:86-107
    (True, 15, "dncnn_15.pth", 1, 17), (True, 25, "dncnn_25.pth", 1, 17),
    (True, 50, "dncnn_50.pth", 1, 17), (True, None, "dncnn_gray_blind.pth", 1, 20),
    (False, None, "dncnn_color_blind.pth", 3, 20),
]


@pytest.mark.parametrize("gray,sigma,fname,nc,nb", DNCNN_CONFIGS)
def test_zoo_routes_every_dncnn_config(tmp_path, gray, sigma, fname, nc, nb):
    _write_dncnn(tmp_path, fname, nc, nb, seed=nb)
    for precision, dtype in (("parity", None), ("serving", "bfloat16")):
        m = zoo.get_model_instance("denoising", "gaussian", "DnCNN", gray=gray, sigma=sigma,
                                   weights_dir=str(tmp_path), precision=precision,
                                   device="cpu")
        assert m.name == "DnCNN" and m.compute_dtype == dtype
        assert (m.patch_size, m.patch_overlap, m.pad_factor, m.pad_block) == (256, 48, None, None)
        assert next(m.net.parameters()).device.type == "cpu"
        assert len(m.net.model) == 2 * nb - 1 and m.net.model[0].in_channels == nc
        assert m.param_count == 64 * 9 * (nc + 64 * (nb - 2) + nc) + 64 * (nb - 1) + nc


@pytest.mark.parametrize("sigma", (15, 25, 50))
def test_zoo_routes_every_rednet_config(tmp_path, sigma):
    """``{sigma}.pt`` first, else ``{sigma}.caffemodel``: the same weights
    either way."""
    _write_rednet(tmp_path, sigma, seed=sigma, caffemodel=True)
    from_caffe = zoo.get_model_instance("denoising", "gaussian", "REDNet", gray=True,
                                        sigma=sigma, weights_dir=str(tmp_path), device="cpu")
    _write_rednet(tmp_path, sigma, seed=sigma)
    m = zoo.get_model_instance("denoising", "gaussian", "REDNet", gray=True, sigma=sigma,
                               weights_dir=str(tmp_path), precision="serving", device="cpu")
    assert (m.name, m.compute_dtype, m.patch_size, m.patch_overlap) == ("REDNet", "bfloat16",
                                                                       128, 32)
    assert from_caffe.compute_dtype is None
    assert from_caffe.param_count == m.param_count == 4_134_785
    a, b = from_caffe.net.state_dict(), m.net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert next(m.net.parameters()).device.type == "cpu"


def test_zoo_builds_on_the_card_by_default():
    import inspect

    for fn in (zoo.get_model_instance, zoo.build_dncnn, zoo.build_rednet, zoo.build_deblurgan):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


@pytest.mark.parametrize("name,gray,sigma,precision", [
    ("DnCNN", True, 25, "parity"), ("DnCNN", False, None, "serving"),
    ("REDNet", True, 50, "parity"), ("REDNet", True, 50, "serving"),
])
def test_engine_matches_tpuir(tmp_path, name, gray, sigma, precision):
    """The released-size model through both zoos and engines on a noisy
    image of two tiles (DnCNN 256/48) or several (REDNet 128/32): 1 LSB."""
    from tpuir import zoo as jzoo
    from tpuir.core.engine import run_model_inference as jax_run

    if name == "DnCNN":
        _write_dncnn(tmp_path, "dncnn_25.pth" if gray else "dncnn_color_blind.pth",
                     1 if gray else 3, 17 if gray else 20, seed=5)
        hw = (40, 290)
    else:
        _write_rednet(tmp_path, sigma, seed=6)
        hw = (60, 150)
    kw = dict(gray=gray, sigma=sigma, weights_dir=str(tmp_path), precision=precision)
    model = zoo.get_model_instance("denoising", "gaussian", name, device="cpu", **kw)
    jmodel = jzoo.get_model_instance("denoising", "gaussian", name, **kw)
    img = (np.random.RandomState(7).rand(*hw, 1 if gray else 3) * 255).astype(np.uint8)
    got, _ = run_model_inference(model, img, need_degradation=True, noise_level=25)
    want, _ = jax_run(jmodel, img, need_degradation=True, noise_level=25)
    _within_one_lsb(got, want)


def test_csv_row_dncnn_sigma25_gray_matches_tpuir(tmp_path, monkeypatch):
    """The gray non-blind suite's DnCNN sigma=25 cell on Set12 (two images,
    the released dncnn_25 shape): the port's row against tpuir's."""
    import cv2

    from tpuir.harness import Harness as JaxHarness
    from tpuir_torch import harness as phar

    ds = tmp_path / "datasets" / "denoising" / "gaussian" / "test" / "Set12"
    ds.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate([(48, 52), (40, 40)]):
        cv2.imwrite(str(ds / f"{i + 1:02d}.png"), (rng.rand(h, w) * 255).astype(np.uint8))
    _write_dncnn(tmp_path / "weights", "dncnn_25.pth", 1, 17, seed=8)
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path / "datasets"))
    monkeypatch.delenv("TPUIR_PRECISION", raising=False)
    cell = dict(datasets=("Set12",), sigmas=(25,), models=("DnCNN",))
    ours = phar.Harness(weights_dir=str(tmp_path / "weights"),
                        results_dir=str(tmp_path / "ours"), device="cpu", save_images=False)
    ours.gaussian_gray_nonblind(**cell)
    theirs = JaxHarness(weights_dir=str(tmp_path / "weights"),
                        results_dir=str(tmp_path / "theirs"), save_images=False)
    theirs.gaussian_gray_nonblind(**cell)
    assert len(ours.results_table) == len(theirs.results_table) == 1
    got, want = ours.results_table[0], theirs.results_table[0]
    assert {k: got[k] for k in TEXT} == {k: want[k] for k in TEXT}
    assert got["Model_Params"] == 555_137  # the released dncnn_25's count
    assert abs(got["PSNR"] - want["PSNR"]) <= PSNR_DB, (got["PSNR"], want["PSNR"])
    assert abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL, (got["SSIM"], want["SSIM"])
