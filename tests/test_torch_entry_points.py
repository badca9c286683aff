"""The port's user entry points against tpuir's on the CPU: the profiling
helpers, the demo's handlers and shell, and the scripts (``test_demo``,
``compute_flops``, ``test_patch_size``, ``validate_serving``).

tpuir's scripts under ``scripts/`` are imported from their files (no
bytecode written, ``sys.path`` and JAX's settings restored), and nothing in
the repository changes. JAX is imported only on the reference side.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpuir_torch import demo_core
from tpuir_torch.core.engine import InferenceModel
from tpuir_torch.models import dncnn as pdncnn
from tpuir_torch.models import rednet as prednet
from tpuir_torch.models.restormer import Restormer, init_state_dict
from tpuir_torch.scripts import compute_flops, test_demo, test_patch_size, validate_serving
from tpuir_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 4, 8),
            layer_norm_bias=False)


def _tree_state(root):
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.path.getmtime(os.path.join(d, f)))
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture
def jax_script(monkeypatch):
    """Import ``scripts/<name>.py`` as a module; check that nothing under
    ``scripts/`` changed and put JAX's settings back afterwards."""
    import jax

    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "path", list(sys.path))
    before = _tree_state(SCRIPTS)
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                               "jax_persistent_cache_min_compile_time_secs")}

    def load(name):
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                      os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield load
    for k, v in saved.items():
        jax.config.update(k, v)
    assert _tree_state(SCRIPTS) == before


# -- the profiling helpers ---------------------------------------------------


def _bad_tree(xp):
    nan, inf = float("nan"), float("inf")
    return {"b": [xp([1.0, nan]), (xp([[inf, -inf]]), xp([0.0]))],
            "a": {"w": xp([nan, nan, inf]), "ok": xp([1.0]), "none": None}}


def test_check_nan_inf_answers_as_tpuir(capsys):
    from tpuir.utils import profiling as jprof

    for tree in (_bad_tree(lambda v: np.asarray(v, np.float32)),
                 {"x": [np.ones(3, np.float32)], "y": (np.zeros(2),)}):
        want = jprof.check_nan_inf(tree, "t")
        want_out = capsys.readouterr().out
        assert profiling.check_nan_inf(tree, "t") == want
        assert capsys.readouterr().out == want_out
    assert profiling.check_nan_inf(_bad_tree(torch.tensor), "t") is True
    assert "t['a']['w']: 2 NaN, 1 Inf" in capsys.readouterr().out
    assert profiling.check_nan_inf({"q": torch.ones(2, dtype=torch.bfloat16)}) is False


def test_timer_records_ms():
    with profiling.Timer() as t:
        sum(range(1000))
    assert 0 <= t.ms < 1000


def _conv_flops(net, h, w):
    return sum(2 * m.in_channels * m.out_channels * m.kernel_size[0] * m.kernel_size[1] * h * w
               for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)))


@pytest.mark.parametrize("name", ("DnCNN", "REDNet"))
def test_flop_count_of_the_plain_conv_families(name):
    """Every layer keeps H x W: 2 C_in C_out k^2 H W a layer, exactly."""
    net = pdncnn.DnCNN(1, 1, 8, 4) if name == "DnCNN" else prednet.REDNet(1, 8)
    x = torch.rand(1, 1, 12, 10)
    assert profiling.flop_count(net, x) == {"flops": _conv_flops(net, 12, 10)}
    assert profiling.flop_count(net, x)["flops"] > 0


def test_compute_flops_has_tpuirs_table(jax_script):
    names = [row[0] for row in jax_script("compute_flops").model_table()]
    assert [row[0] for row in compute_flops.model_table()] == names
    flops, params = compute_flops.compute_flops(lambda: pdncnn.DnCNN(1, 1, 8, 4), 1, size=16)
    assert flops == _conv_flops(pdncnn.DnCNN(1, 1, 8, 4), 16, 16)
    assert params == sum(p.numel() for p in pdncnn.DnCNN(1, 1, 8, 4).parameters())


@pytest.mark.parametrize("family", ("Restormer", "MaIR"))
def test_compute_flops_on_meta_counts_the_cpu_forward(family):
    """The meta count of the plain blocks equals the flop counter on a CPU
    forward of the zoo's blocks (the kernel wrappers' plain versions), at a
    tiny width: no forward runs, no count is lost."""
    from tpuir_torch.models.mair import MaIR

    if family == "Restormer":
        build = lambda fused: Restormer(**TINY, fused=fused)  # noqa: E731
    else:
        build = lambda fused: MaIR(embed_dim=16, depths=(1,), d_state=4,  # noqa: E731
                                   ssm_ratio=1.5, mlp_ratio=2.0, scan_len=4, fused=fused)
    flops, params = compute_flops.compute_flops(lambda: build(False), 3, size=16)
    torch.manual_seed(0)
    net = build(True).eval()
    assert flops == profiling.flop_count(net, torch.rand(1, 3, 16, 16))["flops"] > 0
    assert params == sum(p.numel() for p in net.parameters())


# -- the demo's handlers and shell ----------------------------------------------


def test_demo_tables_equal_tpuirs(tmp_path, monkeypatch):
    from tpuir import demo_core as jdemo

    ds = tmp_path / "denoising" / "gaussian" / "test"
    for name in ("CBSD68", "Set12"):
        (ds / name).mkdir(parents=True)
        for i in (10, 2, 1, 3):
            (ds / name / f"{i}.png").write_bytes(b"")
    monkeypatch.setenv("TPUIR_DATASET_DIR", str(tmp_path))
    assert demo_core.TASKS == jdemo.TASKS
    assert demo_core.SUBTASK_DATASET_DIRS == jdemo.SUBTASK_DATASET_DIRS
    for subs in jdemo.TASKS.values():
        for label in subs:
            assert demo_core.lookup_subtask(label) == jdemo.lookup_subtask(label)
            assert demo_core.subtask_change(label) == jdemo.subtask_change(label)
    for task, sub in (("denoising", "gaussian"), ("denoising", "real"),
                      ("deblurring", "defocus"), ("deblurring", "motion"), ("x", "y")):
        assert demo_core.sample_images(task, sub) == jdemo.sample_images(task, sub)
        for gray in (True, False):
            for blind in (True, False):
                assert (demo_core.available_models(task, sub, gray, blind)
                        == jdemo.available_models(task, sub, gray, blind))
    with pytest.raises(ValueError):
        demo_core.subtask_change("Nonexistent Subtask")


def test_gallery_select_equals_tpuirs(tmp_path):
    import cv2

    from tpuir import demo_core as jdemo

    p = tmp_path / "s.png"
    cv2.imwrite(str(p), (np.random.RandomState(2).rand(10, 12, 3) * 255).astype(np.uint8))
    assert np.array_equal(demo_core.gallery_select(["other", str(p)], 1),
                          jdemo.gallery_select(["other", str(p)], 1))


def test_device_choices_lists_each_card_then_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert demo_core.device_choices() == ["cuda:0", "cuda:1", "cpu"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert demo_core.device_choices() == ["cpu"]


class _Half(torch.nn.Module):
    def forward(self, x):
        return x * 0.5


def _half_model(task, subtask, model_name, gray=False, sigma=None, device=None):
    return InferenceModel(name=f"tiny-{model_name}", net=_Half(), device=torch.device("cpu"),
                          patch_size=32, patch_overlap=8, batch_size=4)


def _jax_half_model(task, subtask, model_name, gray=False, sigma=None):
    from tpuir.core.engine import InferenceModel as JaxInferenceModel

    return JaxInferenceModel(name=f"tiny-{model_name}", apply_fn=lambda p, x: x * 0.5,
                             params=None, patch_size=32, patch_overlap=8, batch_size=4)


@pytest.mark.parametrize("label,model,sigma,noise,shape", [
    ("Gaussian (Color, Non-blind)", "Restormer", 25, True, (70, 90, 3)),
    ("Gaussian (Gray, Non-blind)", "DnCNN", 15, False, (48, 52, 3)),
    ("Gaussian (Gray, Blind)", "DnCNN", 25, True, (40, 44, 3)),
])
def test_run_restoration_equals_tpuirs(label, model, sigma, noise, shape):
    from tpuir import demo_core as jdemo

    img = (np.random.RandomState(sum(shape)).rand(*shape) * 255).astype(np.uint8)
    got = demo_core.run_restoration(img, label, model, sigma, noise, 32, 8, device_name="cpu",
                                    get_model=_half_model)
    want = jdemo.run_restoration(img, label, model, sigma, noise, 32, 8,
                                 get_model=_jax_half_model)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)
    assert got[2].endswith(" ms")


def test_run_restoration_tiny_restormer_within_one_lsb_of_tpuir():
    from tpuir import demo_core as jdemo
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.models import restormer as jres

    sd = init_state_dict(TINY, seed=1)
    hooks = dict(patch_size=32, patch_overlap=8, pad_factor=8, batch_size=4)
    net = Restormer(**TINY, fused=True)
    net.load_state_dict(sd)
    seen = []

    def ours(task, subtask, model_name, gray=False, sigma=None, device=None):
        seen.append((task, subtask, model_name, gray, sigma, device))
        return InferenceModel(name="Restormer", net=net.eval(), device=torch.device(device),
                              **hooks)

    def theirs(task, subtask, model_name, gray=False, sigma=None):
        return JaxInferenceModel(
            name="Restormer",
            apply_fn=jres.Restormer(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                    layer_norm_bias=False).apply,
            params=jres.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                           (1, 1, 1, 1), 1, False, False), **hooks)

    img = (np.random.RandomState(5).rand(50, 70, 3) * 255).astype(np.uint8)
    args = (img, "Gaussian (Color, Non-blind)", "Restormer", 25, True, 32, 8)
    got = demo_core.run_restoration(*args, device_name="cpu", get_model=ours)
    want = jdemo.run_restoration(*args, get_model=theirs)
    assert seen == [("denoising", "gaussian", "Restormer", False, 25, "cpu")]
    assert np.array_equal(got[0], want[0])
    assert np.abs(got[1].astype(int) - want[1].astype(int)).max() <= 1


def test_run_restoration_builds_on_the_card_by_default():
    seen = []

    def get_model(*args, **kw):
        seen.append(kw["device"])
        return _half_model(*args, **kw)

    img = np.zeros((20, 24, 3), np.uint8)
    demo_core.run_restoration(img, "Real Noise", "MaIR", 25, False, 32, 8, get_model=get_model)
    demo_core.run_restoration(img, "Real Noise", "MaIR", 25, False, 32, 8, device_name="cuda:1",
                              get_model=get_model)
    assert seen == ["cuda", "cuda:1"]
    with pytest.raises(ValueError):
        demo_core.run_restoration(None, "Real Noise", "MaIR", 25, False, 32, 8,
                                  get_model=get_model)


def test_demo_shell_without_gradio(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)
    from tpuir_torch.scripts import demo

    assert demo.run_restoration is demo_core.run_restoration
    assert demo.main() == 1
    assert "pip install gradio" in capsys.readouterr().out


# -- test_demo ---------------------------------------------------------------


def test_test_demo_suite_matches_tpuirs(tmp_path, jax_script, capsys):
    """The gray blind suite with a seeded DnCNN (and no Restormer weights)
    on a temporary demo directory: the port's PNG within 1 LSB of the one
    tpuir's ``run_suite`` writes from the same files."""
    import cv2

    from tpuir_torch.core.image_io import imread_uint8

    jtd = jax_script("test_demo")
    suite = next(s for s in test_demo.SUITES if s[0] == "denoising_gaussian_gray_blind")
    assert suite in [tuple(s) for s in jtd.SUITES] and len(test_demo.SUITES) == len(jtd.SUITES)
    wdir = tmp_path / "weights" / "DnCNN"
    wdir.mkdir(parents=True)
    torch.save(pdncnn.init_state_dict(1, 20, seed=4), wdir / "dncnn_gray_blind.pth")
    rng = np.random.RandomState(6)
    clean = (rng.rand(40, 60) * 255).astype(np.uint8)
    noisy = np.clip(clean + rng.randn(40, 60) * 25, 0, 255).astype(np.uint8)
    outs = {}
    for side, mod, kw in (("ours", test_demo, dict(device="cpu")), ("theirs", jtd, {})):
        demo_dir = tmp_path / side
        demo_dir.mkdir()
        cv2.imwrite(str(demo_dir / f"{suite[0]}_noisy.bmp"), noisy)
        cv2.imwrite(str(demo_dir / f"{suite[0]}_target.png"), clean)
        mod.run_suite(*suite, demo_dir=str(demo_dir), weights_dir=str(tmp_path / "weights"),
                      show=False, **kw)
        outs[side] = imread_uint8(str(demo_dir / f"{suite[0]}_result_DnCNN.png"), 1)
        assert not (demo_dir / f"{suite[0]}_result_Restormer.png").exists()
    assert outs["ours"].shape == outs["theirs"].shape == (40, 60, 1)
    assert np.abs(outs["ours"].astype(int) - outs["theirs"].astype(int)).max() <= 1
    assert "Model weights for Restormer not found" in capsys.readouterr().out


def test_test_demo_skips_what_is_missing(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert test_demo.main(["--demo-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[skip] demo images") == len(test_demo.SUITES) + 1


# -- test_patch_size -----------------------------------------------------------


@pytest.mark.parametrize("limit,max_side", [(1000, 2048), (16, 2048), (15, 2048), (2048, 2048),
                                            (300, 512), (700, 640)])
def test_patch_size_search_equals_tpuirs(jax_script, monkeypatch, limit, max_side):
    jps = jax_script("test_patch_size")
    trials = []
    monkeypatch.setattr(jps, "device_budget_bytes", lambda: 0)
    monkeypatch.setattr(jps, "fits", lambda model, in_ch, size, budget: (
        trials.append(size) or size <= limit))
    want = jps.find_max_patch_size(None, 3, max_side=max_side)
    ours = []
    got = test_patch_size.find_max_patch_size(lambda s: ours.append(s) or s <= limit, max_side)
    assert got == want and ours == trials


def test_patch_size_search_lets_other_errors_through():
    def refuses(side):
        raise ValueError(f"the serving kernel takes no side {side}")

    with pytest.raises(ValueError, match="serving kernel"):
        test_patch_size.find_max_patch_size(refuses)


class _Raises(torch.nn.Module):
    def __init__(self, exc):
        super().__init__()
        self.exc = exc

    def forward(self, x):
        if x.shape[-1] > 64:
            raise self.exc
        return x


@pytest.mark.parametrize("exc,fits", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), False),
    (RuntimeError("kernel build failed"), None),
    (ValueError("d must be even"), None),
])
def test_card_fits_counts_only_out_of_memory(monkeypatch, exc, fits):
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    model = InferenceModel(name="m", net=_Raises(exc), device=torch.device("cpu"))
    check = test_patch_size.card_fits(model, 1)
    assert check(64) is True
    if fits is None:
        with pytest.raises(type(exc)):
            check(80)
    else:
        assert check(80) is False
        assert test_patch_size.find_max_patch_size(check, 256) == 64


def test_patch_size_bundles_take_the_zoos_hooks():
    rows = {name: (build, ch) for name, build, ch in compute_flops.model_table()}
    m = test_patch_size.bundle("MaIR (CDN)", *rows["MaIR (CDN)"], "cpu")
    assert (m.pad_factor, m.pad_block, m.compute_dtype) == (8, None, None)
    g = test_patch_size.bundle("DeblurGANv2 (MobileNet)", *rows["DeblurGANv2 (MobileNet)"], "cpu")
    assert (g.pad_factor, g.pad_block, g.compute_dtype) == (None, 32, None)
    d = test_patch_size.bundle("DnCNN (nonblind, gray)", *rows["DnCNN (nonblind, gray)"], "cpu")
    assert (d.pad_factor, d.pad_block, d.compute_dtype) == (None, None, None)
    r = test_patch_size.bundle("Restormer (Dual-pixel)", *rows["Restormer (Dual-pixel)"], "cpu")
    assert r.net.encoder_level1[0].fused and r.pad_factor == 8


# -- validate_serving ----------------------------------------------------------


def test_delta_stats_equal_tpuirs(jax_script):
    jvs = jax_script("validate_serving")
    rng = np.random.RandomState(0)
    for dtype, top in ((np.uint8, 255), (np.uint16, 65535)):
        a = (rng.rand(20, 30, 3) * top).astype(dtype)
        for b in (a.copy(), np.clip(a.astype(np.int64) + rng.randint(-2, 3, a.shape), 0,
                                     top).astype(dtype)):
            assert validate_serving.delta_stats(a, b) == jvs.delta_stats(a, b)


def test_validate_serving_json_has_tpuirs_keys(tmp_path, jax_script, monkeypatch):
    """A DnCNN run of each side on the CPU: the port's record has tpuir's
    keys, each entry at least tpuir's; the trained-like entry says which
    weights it used."""
    import jax

    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.models.dncnn import DnCNN

    jvs = jax_script("validate_serving")
    m = DnCNN(1, 1, 8, 3)
    p = m.init(jax.random.PRNGKey(0), np.zeros((1, 16, 16, 1), np.float32))
    mk = lambda dt: JaxInferenceModel(name="d", apply_fn=m.apply, params=p,  # noqa: E731
                                      patch_size=256, patch_overlap=48, compute_dtype=dt)
    img = (np.random.RandomState(1).rand(24, 28, 1) * 255).astype(np.uint8)
    monkeypatch.setattr(jvs, "random_bundles", lambda: [("DnCNN", mk(None), mk("bfloat16"), img)])
    monkeypatch.setattr(jvs, "trained_like_bundles",
                        lambda: [("DnCNN", mk(None), mk("bfloat16"), img, 25)])
    monkeypatch.chdir(tmp_path)
    jvs.main()
    with open(tmp_path / "benchmarks" / "serving_deltas.json") as f:
        want = json.load(f)

    out = tmp_path / "ours" / "serving_deltas_torch.json"
    assert validate_serving.main(["--families", "DnCNN", "--device", "cpu", "--size", "40x48",
                                  "--weights-dir", str(tmp_path / "none"),
                                  "--out", str(out)]) == 0
    with open(out) as f:
        got = json.load(f)
    assert set(got) == set(want)
    for section in ("deltas", "trained_like"):
        assert set(got[section]) == set(want[section]) == {"DnCNN"}
        assert set(want[section]["DnCNN"]) <= set(got[section]["DnCNN"])
    entry = got["trained_like"]["DnCNN"]
    assert entry["weights"] == "seeded, head scaled by 0.05" and entry["sigma"] == 25
    assert abs(entry["psnr_delta_db"]) < 0.1 and got["backend"] == "cpu"


def test_validate_serving_reads_released_weights(tmp_path):
    """Where the zoo finds the released checkpoint, trained-like uses it."""
    wdir = tmp_path / "DnCNN"
    wdir.mkdir()
    torch.save(pdncnn.init_state_dict(1, 17, seed=2), wdir / "dncnn_25.pth")
    res = validate_serving.validate(["DnCNN"], str(tmp_path), (24, 20), "cpu")
    assert res["trained_like"]["DnCNN"]["weights"] == "released"
    assert res["deltas"]["DnCNN"]["max_lsb"] <= 2
