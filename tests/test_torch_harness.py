"""The port's evaluation harness (``tpuir_torch/harness.py``) and its data
layer against tpuir's on the CPU.

The loaders, the natural sort and the directory roots are held equal to
tpuir's on a small synthetic dataset tree; the CSV rows of the port's
``Harness`` are held to ``tpuir.harness.Harness``'s on the same seeded
``{'params': sd}`` checkpoints (written with ``torch.save`` as released
files are, at the released configs' full width and depth) and the same
synthetic images: the row's text columns and parameter count equal, PSNR
within 5e-3 dB and SSIM within 1e-3 (the tolerance of
``tests/test_csv_row_parity_more.py``). Both run in parity precision with
the same host noise. JAX is imported only on the reference side.
"""

import csv
import io
import os

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

from tpuir_torch import config as pconfig
from tpuir_torch import harness as phar
from tpuir_torch.data import loaders as ploaders
from tpuir_torch.models import mair as pmair
from tpuir_torch.models import restormer as prestormer
from tpuir_torch.utils.natsort import natsorted

PSNR_DB, SSIM_TOL = 5e-3, 1e-3
TEXT = ("Task", "Type", "Dataset", "Sigma", "Model", "Model_Params")


def _write_images(d, names, shape, seed, gray=False):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        img = (rng.rand(*shape, 1 if gray else 3) * 255).astype(np.uint8)
        cv2.imwrite(str(d / name), img if gray else img[..., ::-1])


def _dataset_tree(root):
    """A small tree in the datasets' layout: gaussian test sets (color and
    gray), SIDD blocks in both .mat layouts, DPDD and a motion-blur set."""
    from scipy.io import savemat

    g = root / "denoising" / "gaussian" / "test"
    _write_images(g / "CBSD68", ["img10.png", "img2.png", "Img1.png"], (12, 10), 0)
    _write_images(g / "Set12", ["01.png", "11.png", "2.png"], (9, 8), 1, gray=True)
    rng = np.random.RandomState(2)
    for name, shape in (("SIDD", (2, 6, 5, 3)), ("SIDD5", (2, 2, 6, 5, 3))):
        d = root / "denoising" / "real" / "test" / name
        d.mkdir(parents=True)
        for key in ("ValidationNoisyBlocksSrgb", "ValidationGtBlocksSrgb"):
            savemat(str(d / f"{key}.mat"), {key: (rng.rand(*shape) * 255).astype(np.uint8)})
    dp = root / "deblurring" / "defocus" / "test" / "DPDD"
    for sub in ("inputC", "target"):
        _write_images(dp / sub, ["a1.png", "a10.png", "a2.png"], (8, 6), 3)
    for sub in ("inputL", "inputR"):
        (dp / sub).mkdir(parents=True)
        for name in ("a1.png", "a10.png", "a2.png"):
            cv2.imwrite(str(dp / sub / name), (rng.rand(8, 6, 3) * 65535).astype(np.uint16))
    mb = root / "deblurring" / "motion" / "test" / "GoPro"
    for sub in ("input", "target"):
        _write_images(mb / sub, ["f_3.png", "f_12.png"], (7, 9), 4)


def _same_items(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and np.array_equal(u, v)
            else:
                assert u == v


def test_natsort_and_roots_match_tpuir():
    from tpuir import config as jconfig
    from tpuir.utils.natsort import natsorted as jnatsorted

    names = ["img10.png", "img2.png", "Img1.png", "a", "a01b2", "a1b10", "B3", "b03", "10", "9x"]
    assert natsorted(names) == jnatsorted(names)
    for root in ("ROOT_DATASET_DIR", "ROOT_WEIGHTS_DIR", "ROOT_RESULTS_DIR"):
        assert getattr(pconfig, root) == getattr(jconfig, root)


def test_loaders_match_tpuir(tmp_path, monkeypatch):
    from tpuir.data import loaders as jloaders

    _dataset_tree(tmp_path)
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path))
    calls = [("gaussian_noise_dataset_loader", ("CBSD68", 3)),
             ("gaussian_noise_dataset_loader", ("Set12", 1)),
             ("real_noise_dataset_loader", ("SIDD",)),
             ("real_noise_dataset_loader", ("SIDD5",)),
             ("defocus_blur_dataset_loader", ("DPDD", False)),
             ("defocus_blur_dataset_loader", ("DPDD", True)),
             ("motion_blur_dataset_loader", ("GoPro",))]
    for fn, args in calls:
        got, want = getattr(ploaders, fn)(*args), getattr(jloaders, fn)(*args)
        assert len(got) == len(want), fn
        _same_items(got, want)


def _checkpoints(root):
    """Seeded released-layout checkpoints of Restormer sigma15 color and
    MaIR-CDN sigma15, full width and depth."""
    w = root / "weights"
    (w / "Restormer" / "denoising").mkdir(parents=True)
    (w / "MaIR" / "denoising").mkdir(parents=True)
    torch.save({"params": prestormer.init_state_dict(dict(layer_norm_bias=False), seed=0)},
               w / "Restormer" / "denoising" / "gaussian_color_denoising_sigma15.pth")
    torch.save({"params": pmair.init_state_dict(None, seed=0)},
               w / "MaIR" / "denoising" / "MaIR_CDN_s15.pth")
    return w


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_csv_rows_match_tpuir(tmp_path, monkeypatch):
    """Restormer and MaIR-CDN sigma15 color, parity, on two 16x16 images (one
    tile each): the port's rows and CSV against tpuir's."""
    from tpuir.harness import Harness as JaxHarness

    weights = _checkpoints(tmp_path)
    _write_images(tmp_path / "datasets" / "denoising" / "gaussian" / "test" / "CBSD68",
                  ["1.png", "2.png"], (16, 16), 5)
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path / "datasets"))
    monkeypatch.delenv("TPUIR_PRECISION", raising=False)
    monkeypatch.delenv("TPUIR_RECUR_BF16", raising=False)
    cell = dict(datasets=("CBSD68",), sigmas=(15,), models=("Restormer", "MaIR"))
    ours = phar.Harness(weights_dir=str(weights), results_dir=str(tmp_path / "ours"),
                        device="cpu")
    ours.gaussian_color_nonblind(**cell)
    theirs = JaxHarness(weights_dir=str(weights), results_dir=str(tmp_path / "theirs"))
    theirs.gaussian_color_nonblind(**cell)
    assert [r["Model"] for r in ours.results_table] == ["Restormer", "MaIR"]
    for got, want in zip(ours.results_table, theirs.results_table):
        assert {k: got[k] for k in TEXT} == {k: want[k] for k in TEXT}
        assert abs(got["PSNR"] - want["PSNR"]) <= PSNR_DB, (got["PSNR"], want["PSNR"])
        assert abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL, (got["SSIM"], want["SSIM"])
    # the saved images are the port's predictions, under tpuir's layout
    for sub in ("Restormer", "MaIR"):
        d = "Gaussian_Denoising_Color_Nonblind/CBSD68_Sig15/" + sub
        assert sorted(os.listdir(tmp_path / "ours" / d)) == sorted(
            os.listdir(tmp_path / "theirs" / d)) == ["1.png", "2.png"]
    got_csv, want_csv = ours.save_results(), theirs.save_results()
    with open(got_csv) as f, open(want_csv) as g:
        assert f.readline() == g.readline()  # the header
    for got, want in zip(_csv_rows(got_csv), _csv_rows(want_csv)):
        assert {k: got[k] for k in TEXT} == {k: want[k] for k in TEXT}
        assert float(got["PSNR"]) == pytest.approx(float(want["PSNR"]), abs=PSNR_DB)


def test_unported_family_cell_is_skipped(tmp_path, monkeypatch, capsys):
    """A DnCNN cell whose checkpoint is missing prints a skip and leaves no
    row (the zoo raises FileNotFoundError); so does a Restormer one."""
    _write_images(tmp_path / "datasets" / "denoising" / "gaussian" / "test" / "CBSD68",
                  ["1.png"], (8, 8), 6)
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path / "datasets"))
    h = phar.Harness(weights_dir=str(tmp_path / "weights"), results_dir=str(tmp_path / "r"),
                     device="cpu")
    h.gaussian_color_blind(datasets=("CBSD68",), sigmas=(15,), models=("DnCNN", "Restormer"))
    out = capsys.readouterr().out
    assert "weights for DnCNN not found" in out and "weights for Restormer not found" in out
    assert h.results_table == []
    with open(h.save_results()) as f:
        assert len(f.read().splitlines()) <= 1  # no row


def test_main_takes_the_test_scripts_flags(tmp_path, monkeypatch, capsys):
    """``python -m tpuir_torch.harness`` takes scripts/tests.py's flags and
    writes the summary CSV under --results-dir."""
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path / "datasets"))
    rc = phar.main(["--weights-dir", str(tmp_path / "w"), "--results-dir", str(tmp_path / "r"),
                    "--no-save-images", "--suites", "color_blind", "gray_blind"])
    assert rc == 0 and (tmp_path / "r" / "results_summary.csv").exists()
    assert "Using device" in capsys.readouterr().out


def test_harness_defaults_to_the_card():
    assert phar.Harness().device == "cuda"
