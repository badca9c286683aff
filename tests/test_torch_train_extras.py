"""The port's training extras against tpuir on the CPU: DeblurGANv2's
augmentations and metrics, MATLAB's imresize, flow IO, NIQE and FID with
the FID Inception, the video datasets, SIDD packaging, the meta-info and
lmdb scripts, and the registries.

* NumPy copies bit for bit under the same seeds: ``deblurgan_aug`` (one
  ``RandomState``; the cv2 transforms included, since this box has cv2;
  without cv2 they raise), ``matlab_resize``, ``flow_io``, NIQE (seeded
  pristine parameters in ``tmp_path``), ``feature_stats`` and the FID;
* DeblurGANv2's SSIM (a depthwise conv here, tpuir's on NHWC) within 1e-6,
  its PSNR, ``tensor2im`` and ``get_images_and_metrics`` exactly;
* the FID Inception's forward at atol 1e-4 (seeded weights, EvalBN's
  running statistics random), its resize to 299 against
  ``jax.image.resize``, a seeded checkpoint written and read back, and
  ``state_dict_from_jax``;
* FFHQDataset, VideoTestDataset, REDSDataset (with and without flow) and
  Vimeo90KDataset on ``tmp_path`` trees: the same samples as tpuir's under
  the same seeds;
* ``sidd_submission`` and the two scripts (meta-info files equal to
  tpuir's; the lmdb-absent path);
* the registries' names equal to tpuir's after both packages' ``train``
  and ``extra_metrics`` are imported.

tpuir's ``scripts/*.py`` are imported from their files, with no bytecode
written. JAX is imported only on the reference side.
"""

import importlib.util
import os
import random
import sys

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

from tpuir_torch.train import deblurgan_aug as pa
from tpuir_torch.train import deblurgan_metrics as pm
from tpuir_torch.train import extra_metrics as pem
from tpuir_torch.train import fid_inception as pfid
from tpuir_torch.utils import flow_io as pflow
from tpuir_torch.utils import matlab_resize as pmr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
cv2 = pytest.importorskip("cv2")


def _img(h, w, seed, c=3):
    return (np.random.RandomState(seed).rand(h, w, c) * 255).astype(np.uint8)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# -- deblurgan_aug ---------------------------------------------------------------


@pytest.mark.parametrize("scope,crop", [("weak", "random"), ("geometric", "random"),
                                        ("geometric", "center")])
def test_paired_transforms_bit_for_bit(scope, crop):
    from tpuir.train import deblurgan_aug as ja

    got_fn, want_fn = pa.get_transforms(24, scope, crop), ja.get_transforms(24, scope, crop)
    drawn = set()
    for seed in range(12):  # every geometric transform is drawn in these seeds
        a, b = _img(30, 26, seed), _img(30, 26, seed + 100)
        if seed % 4 == 0:  # smaller than the crop: the reflect pad
            a, b = a[:20], b[:20]
        got = got_fn(a, b, np.random.RandomState(seed))
        want = want_fn(a, b, np.random.RandomState(seed))
        assert _same(got[0], want[0]) and _same(got[1], want[1]), seed
        drawn.add(np.random.RandomState(seed).randint(5))
    if scope == "geometric":
        assert drawn == set(range(5))
    na, nb = pa.get_normalize()(a, b)
    ja_, jb = ja.get_normalize()(a, b)
    assert _same(na, ja_) and _same(nb, jb)


@pytest.mark.parametrize("name", sorted(pa._CORRUPT_FNS))
def test_each_corruption_bit_for_bit(name):
    from tpuir.train import deblurgan_aug as ja

    img = _img(32, 28, 7)
    for seed in range(3):
        got = pa._CORRUPT_FNS[name](img, np.random.RandomState(seed))
        want = ja._CORRUPT_FNS[name](img, np.random.RandomState(seed))
        assert _same(got, want), (name, seed)


def test_corrupt_function_bit_for_bit():
    from tpuir.train import deblurgan_aug as ja

    config = [{"name": n, "prob": p} for n, p in zip(sorted(pa._CORRUPT_FNS),
                                                     (0.5, 0.2, 0.7, 0.1, 0.3, 0.5, 0.4,
                                                      0.6, 0.2, 0.9))]
    config[0]["num_holes"] = 3
    got_fn, want_fn = pa.get_corrupt_function(config), ja.get_corrupt_function(config)
    for seed in range(20):
        img = _img(24, 24, seed)
        assert _same(got_fn(img, np.random.RandomState(seed)),
                     want_fn(img, np.random.RandomState(seed))), seed
    with pytest.raises(KeyError):
        pa.get_corrupt_function([{"name": "bogus"}])


def test_transforms_that_need_cv2_raise_without_it(monkeypatch):
    monkeypatch.setattr(pa, "_HAS_CV2", False)
    img = _img(16, 16, 1)
    with pytest.raises(RuntimeError, match="requires cv2"):
        pa._shift_scale_rotate(img, img, np.random.RandomState(0))
    with pytest.raises(RuntimeError, match="requires cv2"):
        pa._CORRUPT_FNS["jpeg"](img, np.random.RandomState(0))
    out = pa._CORRUPT_FNS["gamma"](img, np.random.RandomState(0))  # NumPy only
    assert out.shape == img.shape


# -- matlab_resize, flow_io ------------------------------------------------------


@pytest.mark.parametrize("shape,scale,aa,dtype", [
    ((23, 17, 3), 0.5, True, np.float64), ((23, 17), 0.5, True, np.float32),
    ((16, 20, 3), 0.25, False, np.uint8), ((9, 11, 1), 2.0, True, np.float64),
    ((12, 12, 3), 1 / 3, True, np.uint8)])
def test_matlab_imresize_bit_for_bit(shape, scale, aa, dtype):
    from tpuir.utils.matlab_resize import imresize

    a = np.random.RandomState(3).rand(*shape)
    a = (a * 255).astype(np.uint8) if dtype == np.uint8 else a.astype(dtype)
    assert _same(pmr.imresize(a, scale, aa), imresize(a, scale, aa))


def test_flow_io_bit_for_bit(tmp_path):
    from tpuir.utils import flow_io as jf

    flow = (np.random.RandomState(4).randn(7, 9, 2) * 3).astype(np.float32)
    pflow.flowwrite(flow, str(tmp_path / "a.flo"))
    jf.flowwrite(flow, str(tmp_path / "b.flo"))
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    assert _same(pflow.flowread(str(tmp_path / "b.flo")), jf.flowread(str(tmp_path / "a.flo")))
    for norm in (True, False):
        got, want = pflow.quantize_flow(flow, 0.5, norm), jf.quantize_flow(flow, 0.5, norm)
        assert all(_same(g, w) for g, w in zip(got, want))
        assert _same(pflow.dequantize_flow(*got, max_val=0.5, denorm=norm),
                     jf.dequantize_flow(*want, max_val=0.5, denorm=norm))
    (tmp_path / "bad.flo").write_bytes(np.float32(1.0).tobytes() * 3)
    with pytest.raises(ValueError):
        pflow.flowread(str(tmp_path / "bad.flo"))


# -- NIQE and FID ----------------------------------------------------------------


@pytest.fixture
def pris_params(tmp_path):
    rng = np.random.RandomState(5)
    a = rng.randn(36, 36)
    path = str(tmp_path / "niqe_pris_params.npz")
    np.savez(path, mu_pris_param=rng.randn(36) * 0.5 + 1.0, cov_pris_param=a @ a.T / 36 + np.eye(36))
    return path


@pytest.mark.parametrize("convert_to,crop", [("y", 0), ("gray", 4), ("none", 0)])
def test_niqe_bit_for_bit(pris_params, monkeypatch, convert_to, crop):
    from tpuir.train import extra_metrics as jem

    img = _img(200, 196, 8)
    got = pem.calculate_niqe(img, crop, convert_to=convert_to, params_path=pris_params)
    want = jem.calculate_niqe(img, crop, convert_to=convert_to, params_path=pris_params)
    assert np.isfinite(got) and got == want
    monkeypatch.setenv("TPUIR_NIQE_PARAMS", pris_params)
    assert pem.calculate_niqe(img, crop, convert_to=convert_to) == want
    monkeypatch.delenv("TPUIR_NIQE_PARAMS")
    with pytest.raises(FileNotFoundError):
        pem.calculate_niqe(img, crop)


def test_feature_stats_and_fid_bit_for_bit():
    from tpuir.train import extra_metrics as jem

    rng = np.random.RandomState(9)
    a, b = rng.randn(40, 8), rng.randn(40, 8) + 0.3
    for x in (a, b):
        got, want = pem.feature_stats(x), jem.feature_stats(x)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    sa, sb = pem.feature_stats(a), pem.feature_stats(b)
    assert pem.calculate_fid_from_stats(*sa, *sb) == jem.calculate_fid_from_stats(*sa, *sb)
    # rank-deficient covariances (fewer samples than dimensions): the eps path
    c = rng.randn(5, 12)
    sc = pem.feature_stats(c)
    assert pem.calculate_fid_from_stats(*sc, *sc) == jem.calculate_fid_from_stats(*sc, *sc)


# -- DeblurGANv2's metrics ---------------------------------------------------------


def test_deblurgan_ssim_psnr_and_images():
    from tpuir.train import deblurgan_metrics as jm

    rng = np.random.RandomState(10)
    a = rng.rand(2, 20, 24, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    got = float(pm.ssim(torch.from_numpy(a).permute(0, 3, 1, 2),
                        torch.from_numpy(b).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got, float(jm.ssim(a, b)), rtol=0, atol=1e-6)
    ua, ub = _img(9, 7, 11), _img(9, 7, 12)
    assert pm.psnr(ua, ub) == jm.psnr(ua, ub) and pm.psnr(ua, ua) == jm.psnr(ua, ua) == 100.0
    signed = [(rng.rand(1, 12, 10, 3) * 2 - 1).astype(np.float32) for _ in range(3)]
    tensors = [torch.from_numpy(s).permute(0, 3, 1, 2) for s in signed]
    assert _same(pm.tensor2im(tensors[0]), jm.tensor2im(signed[0]))
    got, want = pm.get_images_and_metrics(*tensors), jm.get_images_and_metrics(*signed)
    assert got[0] == want[0] and got[1] == want[1] and _same(got[2], want[2])


# -- the FID Inception -------------------------------------------------------------


@pytest.fixture(scope="module")
def fid():
    from tpuir.train.fid_inception import convert_fid_inception_state_dict

    sd = pfid.init_state_dict(seed=13)
    net = pfid.InceptionV3FID(resize_input=False)
    net.load_state_dict(sd)
    return dict(sd=sd, net=net.eval(),
                params=convert_fid_inception_state_dict({k: v.numpy() for k, v in sd.items()}))


def test_fid_inception_forward_matches_tpuir(fid):
    import jax

    from tpuir.train.fid_inception import InceptionV3FID

    x = np.random.RandomState(14).rand(2, 75, 75, 3).astype(np.float32)
    want = np.asarray(jax.jit(InceptionV3FID(resize_input=False).apply)(fid["params"], x))
    with torch.no_grad():
        got = fid["net"](torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, pfid.FID_DIMS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # EvalBN reads the running statistics in any mode
    with torch.no_grad():
        assert torch.equal(fid["net"].train()(torch.from_numpy(x).permute(0, 3, 1, 2)),
                           torch.from_numpy(got))
    fid["net"].eval()


@pytest.mark.parametrize("hw", [(64, 64), (299, 299), (320, 352), (150, 420)])
def test_fid_resize_is_tpuir_s(hw):
    """Within the features' own bound: shrinking, the two compute the same
    triangle weights in float32 in another order (1.1e-5 at most here)."""
    import jax

    x = np.random.RandomState(15).rand(1, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, 299, 299, 3), method="bilinear"))
    got = pfid.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if hw == (299, 299):
        assert np.array_equal(got, x)


def test_fid_checkpoint_read_back_and_features(fid, tmp_path):
    from jax.tree_util import tree_leaves_with_path

    from tpuir.train import fid_inception as jfid

    path = str(tmp_path / "pt_inception.pth")
    extra = {"fc.weight": torch.zeros(4, 2048), "AuxLogits.conv0.conv.weight": torch.zeros(1)}
    torch.save({**fid["sd"], **extra}, path)
    net = pfid.load_patched_inception_v3(path, resize_input=False, device="cpu")
    assert not net.training
    assert all(torch.equal(v, fid["sd"][k]) for k, v in net.state_dict().items())
    rng = np.random.RandomState(16)
    batches = [rng.rand(2, 75, 75, 3).astype(np.float32), rng.rand(75, 75, 3).astype(np.float32)]
    got = pfid.extract_inception_features(iter(batches), net)
    want = jfid.extract_inception_features(iter(batches), jfid.InceptionV3FID(resize_input=False),
                                           fid["params"])
    assert got.shape == want.shape == (3, pfid.FID_DIMS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    back = pfid.state_dict_from_jax(fid["params"])
    assert back.keys() == fid["sd"].keys()
    for k, v in back.items():
        want_v = torch.zeros_like(v) if k.endswith("num_batches_tracked") else fid["sd"][k]
        assert torch.equal(v, want_v), k
    again = dict(tree_leaves_with_path(jfid.convert_fid_inception_state_dict(
        {k: v.numpy() for k, v in back.items()})))
    assert all(np.array_equal(np.asarray(again[p]), np.asarray(leaf))
               for p, leaf in tree_leaves_with_path(fid["params"]))
    with pytest.raises(KeyError):
        torch.save({k: v for k, v in fid["sd"].items() if "Mixed_7c" not in k}, path)
        pfid.load_patched_inception_v3(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pfid.load_patched_inception_v3()


# -- video datasets ----------------------------------------------------------------


def _png(path, seed, h=32, w=40, gray=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = _img(h, w, seed, 1 if gray else 3)
    cv2.imwrite(path, img[..., 0] if gray else img)


def _reds(root, flow=False):
    """Four REDS clips of 100 frames (the dataset re-centers a window that
    leaves frames 0-99), 16x20, flows stacked (dx; dy) as 32x20 gray PNGs."""
    gt, lq, fl = (os.path.join(root, d) for d in ("gt", "lq", "flow"))
    meta = os.path.join(root, "meta.txt")
    with open(meta, "w") as f:
        for ci, c in enumerate(("000", "001", "015", "240")):
            f.write(f"{c} 100 (16,20,3)\n")
            for i in range(100):
                _png(os.path.join(gt, c, f"{i:08d}.png"), 1000 * ci + i, h=16, w=20)
                _png(os.path.join(lq, c, f"{i:08d}.png"), 500 + 1000 * ci + i, h=16, w=20)
                for tag in ("p1", "n1") if flow else ():
                    _png(os.path.join(fl, c, f"{i:08d}_{tag}.png"), 900 + i, h=32, w=20,
                         gray=True)
    return gt, lq, fl, meta


def _compare_items(got, want, indices=None):
    assert len(got) == len(want)
    for i in range(len(want)) if indices is None else indices:
        g, w = got[i], want[i]
        assert g.keys() == w.keys(), i
        for k in w:
            assert _same(g[k], w[k]) if isinstance(w[k], np.ndarray) else g[k] == w[k], (i, k)


def _both(opt):
    import tpuir.train  # noqa: F401  (registers tpuir's datasets)
    from tpuir.train.data import build_dataset as jbuild

    from tpuir_torch.train.data import build_dataset

    return build_dataset(dict(opt)), jbuild(dict(opt))


@pytest.mark.parametrize("flow,partition,reverse", [(False, "REDS4", False),
                                                    (True, "official", True)])
def test_reds_dataset_samples_match_tpuir(tmp_path, flow, partition, reverse):
    gt, lq, fl, meta = _reds(str(tmp_path), flow=flow)
    opt = {"type": "REDSDataset", "dataroot_gt": gt, "dataroot_lq": lq,
           "dataroot_flow": fl if flow else None, "meta_info_file": meta,
           "val_partition": partition, "io_backend": {"type": "disk"}, "num_frame": 3,
           "gt_size": 16, "interval_list": [1, 2], "random_reverse": reverse,
           "use_flip": True, "use_rot": True, "scale": 1}
    got, want = _both({**opt, "rng": random.Random(3)})
    want.rng = random.Random(3)
    got.rng = random.Random(3)
    assert got.keys == want.keys
    _compare_items(got, want, [0, 1, 2, 57, len(want) - 2, len(want) - 1])
    with pytest.raises(ValueError):
        _both({**opt, "num_frame": 4})


def test_vimeo_ffhq_and_video_test_datasets_match_tpuir(tmp_path):
    root = str(tmp_path)
    meta = os.path.join(root, "meta.txt")
    with open(meta, "w") as f:
        for j, k in enumerate(("00001/0001", "00001/0002")):
            f.write(f"{k} 7 (32,40,3)\n")
            for i in range(1, 8):
                _png(os.path.join(root, "vgt", k, f"im{i}.png"), 10 * j + i)
                _png(os.path.join(root, "vlq", k, f"im{i}.png"), 100 + 10 * j + i)
    opt = {"type": "Vimeo90KDataset", "dataroot_gt": os.path.join(root, "vgt"),
           "dataroot_lq": os.path.join(root, "vlq"), "meta_info_file": meta,
           "io_backend": {"type": "disk"}, "num_frame": 5, "gt_size": 16,
           "random_reverse": True, "use_flip": True, "use_rot": True, "scale": 1,
           "rng": random.Random(4)}
    got, want = _both(opt)
    got.rng, want.rng = random.Random(4), random.Random(4)
    _compare_items(got, want)

    for i in range(3):
        _png(os.path.join(root, "ffhq", f"{i}.png"), 200 + i)
    _compare_items(*_both({"type": "FFHQDataset", "dataroot_gt": os.path.join(root, "ffhq")}))

    for clip in ("a", "b"):
        for i in range(3):
            _png(os.path.join(root, "tlq", clip, f"{i}.png"), 300 + i)
            _png(os.path.join(root, "tgt", clip, f"{i}.png"), 400 + i)
    for n in (1, 3):
        _compare_items(*_both({"type": "VideoTestDataset", "num_frame": n,
                               "dataroot_lq": os.path.join(root, "tlq"),
                               "dataroot_gt": os.path.join(root, "tgt")}))


# -- SIDD packaging and the scripts ------------------------------------------------


def test_sidd_submission_matches_tpuir(tmp_path):
    import scipy.io as sio

    from tpuir.utils.sidd_submission import bundle_srgb_submission as jbundle

    from tpuir_torch.utils.sidd_submission import bundle_srgb_submission

    res = tmp_path / "res"
    for i in range(6):
        _png(str(res / f"{i}.png"), 600 + i, h=8, w=8)
    got = sio.loadmat(bundle_srgb_submission(str(res), str(tmp_path / "a"), 2, 3))
    want = sio.loadmat(jbundle(str(res), str(tmp_path / "b"), 2, 3))
    blocks, wblocks = got["DenoisedBlocksSrgb"], want["DenoisedBlocksSrgb"]
    assert blocks.shape == wblocks.shape == (2, 3)
    assert all(_same(blocks[i, j], wblocks[i, j]) for i in range(2) for j in range(3))
    assert got["TimeMPSrgb"] == want["TimeMPSrgb"]
    with pytest.raises(ValueError):
        bundle_srgb_submission(str(res), str(tmp_path / "c"), 2, 4)


@pytest.fixture
def tpuir_script(monkeypatch):
    """Import ``scripts/<name>.py`` from its file, no bytecode written,
    ``sys.path`` restored afterwards."""
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "path", list(sys.path))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"tpuir_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load


def test_make_meta_info_matches_tpuir(tpuir_script, tmp_path, capsys):
    from tpuir_torch.scripts import make_meta_info

    ref = tpuir_script("make_meta_info")
    (tmp_path / "list.txt").write_text("00001/0001\n\n00002/0003\n")
    for c, n in (("c1", 3), ("c2", 2)):
        for i in range(n):
            _png(str(tmp_path / "scan" / c / f"{i}.png"), 700 + i, h=12, w=10)
    (tmp_path / "scan" / "notes.txt").write_text("not a clip")
    for argv in (["reds"], ["reds4"], ["redsofficial4"], ["redsval"],
                 ["vimeo", "--list", str(tmp_path / "list.txt")],
                 ["scan", "--root", str(tmp_path / "scan")]):
        make_meta_info.main(argv)
        got = capsys.readouterr().out
        ref.main(argv)
        assert got == capsys.readouterr().out, argv
    assert got == "c1 3 (12,10,3)\nc2 2 (12,10,3)\n"


def test_create_lmdb_without_lmdb(tpuir_script, tmp_path, monkeypatch, capsys):
    from tpuir_torch.scripts import create_lmdb

    ref = tpuir_script("create_lmdb")
    monkeypatch.setitem(sys.modules, "lmdb", None)
    assert create_lmdb.make_lmdb_from_folder(str(tmp_path), str(tmp_path / "x.lmdb")) == 1
    got = capsys.readouterr().out
    assert ref.make_lmdb_from_folder(str(tmp_path), str(tmp_path / "x.lmdb")) == 1
    assert got == capsys.readouterr().out == (
        "the lmdb package is not installed; `pip install lmdb` first\n")


def test_registries_match_tpuir():
    import tpuir.train  # noqa: F401
    import tpuir.train.extra_metrics  # noqa: F401
    from tpuir import registry as jreg

    import tpuir_torch.train  # noqa: F401
    from tpuir_torch import registry as preg

    for name in ("DATASET_REGISTRY", "ARCH_REGISTRY", "MODEL_REGISTRY", "LOSS_REGISTRY",
                 "METRIC_REGISTRY"):
        got, want = getattr(preg, name), getattr(jreg, name)
        assert sorted(got._obj_map) == sorted(want._obj_map), name
    assert "calculate_niqe" in preg.METRIC_REGISTRY._obj_map
