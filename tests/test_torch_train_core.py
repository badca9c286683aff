"""The port's training core (``tpuir_torch/train/``, ``tpuir_torch/registry.py``)
against tpuir's on the CPU: option files, schedules, losses, metrics,
datasets and their batches, mixup, and the optimizer step (Adam, AdamW,
the gradient clip, the EMA) fed the same gradients.

Tolerances: option dicts equal (but for the device keys, ``num_gpu`` and
``device``); schedules within 1e-9; losses within 1e-6 (relative, where a
loss exceeds 1: float32's rounding of a sum); metrics, dataset
samples, batches and mixup bit for bit; weights after the optimizer's
steps within 1e-6.
"""

import functools
import glob
import os
import random

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_FILES = sorted(glob.glob(os.path.join(REPO, "options", "train", "*.yml"))
                      + glob.glob(os.path.join(REPO, "options", "test", "*.yml")))
DEVICE_KEYS = ("num_gpu", "device")


@pytest.mark.parametrize("path", OPTION_FILES, ids=os.path.basename)
def test_option_files_parse_as_tpuir(path):
    from tpuir.train.options import parse_options as jax_parse
    from tpuir_torch.train.options import parse_options

    is_train = "/train/" in path
    force = ["--force_yml", "name=forced", "path:resume_state=~/x.state"]
    random.seed(0)
    want, _ = jax_parse("/nowhere", is_train, ["-opt", path, *force])
    random.seed(0)
    got, _ = parse_options("/nowhere", is_train, ["-opt", path, *force, "--device", "cpu"])
    assert got["device"] == "cpu" and got["num_gpu"] == torch.cuda.device_count()
    strip = lambda o: {k: v for k, v in o.items() if k not in DEVICE_KEYS}  # noqa: E731
    assert list(strip(got)) == list(strip(want))
    assert strip(got) == strip(want)


def test_options_refuse_a_launcher():
    from tpuir_torch.train.options import parse_options

    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        parse_options("/nowhere", True, ["-opt", OPTION_FILES[0], "--launcher", "pytorch"])


def test_dict2str_as_tpuir():
    from tpuir.train.options import dict2str as jax_dict2str, yaml_load
    from tpuir_torch.train.options import dict2str

    opt = yaml_load(OPTION_FILES[0])
    assert dict2str(opt) == jax_dict2str(opt)


SCHEDULES = [
    ("CosineAnnealingRestartCyclicLR",
     dict(periods=[10, 25], restart_weights=[1, 0.5], eta_mins=[3e-4, 1e-6]), 40),
    ("CosineAnnealingRestartCyclicLR",  # the Restormer files' schedule, cut
     dict(periods=[92, 208], restart_weights=[1, 1], eta_mins=[3e-4, 1e-6]), 320),
    ("CosineAnnealingRestartLR", dict(periods=[8, 16], restart_weights=[1, 0.7],
                                      eta_min=1e-7), 30),
    ("MultiStepRestartLR", dict(milestones=[5, 12], gamma=0.5), 30),
    ("MultiStepRestartLR", dict(milestones=[5, 12], gamma=0.5, restarts=[0, 8],
                                restart_weights=[1, 0.5]), 30),
    ("TrueCosineAnnealingLR", dict(T_max=20, eta_min=1e-6), 30),
]


@pytest.mark.parametrize("kind,kwargs,steps", SCHEDULES)
def test_schedules_match_tpuir(kind, kwargs, steps):
    from tpuir.train.schedulers import build_scheduler as jax_build
    from tpuir_torch.train.schedulers import build_scheduler

    want, got = jax_build(3e-4, {"type": kind, **kwargs}), build_scheduler(3e-4, {"type": kind,
                                                                                **kwargs})
    for step in range(steps):
        assert abs(got(step) - float(want(step))) < 1e-9, step


def _loss_close(got, want):
    return abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


def _nhwc_pair(seed, shape=(2, 12, 10, 3)):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _t(a):
    """NHWC NumPy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


LOSS_CASES = {
    "l1": ("l1_loss", {}), "l1_sum": ("l1_loss", {"reduction": "sum"}),
    "l1_weighted": ("l1_loss", {"weight": "w1"}),
    "l1_weighted_c": ("l1_loss", {"weight": "wc"}),
    "l1_none_weighted": ("l1_loss", {"weight": "w1", "reduction": "none"}),
    "mse": ("mse_loss", {"loss_weight": 0.5}),
    "mse_weighted": ("mse_loss", {"weight": "w1"}),
    "charbonnier": ("charbonnier_loss", {"eps": 1e-6}),
    "psnr": ("psnr_loss", {}), "psnr_y": ("psnr_loss", {"to_y": True}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_pixel_losses_match_tpuir(case):
    from tpuir.train import losses as jl
    from tpuir_torch.train import losses as pl

    name, kw = LOSS_CASES[case]
    p, t = _nhwc_pair(1)
    rng = np.random.RandomState(2)
    weights = {"w1": rng.rand(2, 12, 10, 1).astype(np.float32),
               "wc": rng.rand(2, 12, 10, 3).astype(np.float32)}
    jkw = {k: weights.get(v, v) if k == "weight" else v for k, v in kw.items()}
    pkw = {k: _t(weights[v]) if k == "weight" else v for k, v in kw.items()}
    want = np.asarray(getattr(jl, name)(p, t, **jkw))
    got = getattr(pl, name)(_t(p), _t(t), **pkw)
    if want.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_tv_loss_matches_tpuir():
    from tpuir.train import losses as jl
    from tpuir_torch.train import losses as pl

    p, w = _nhwc_pair(3)
    for weight in (None, w):
        want = float(jl.weighted_tv_loss(p, weight=weight, loss_weight=0.7))
        got = float(pl.weighted_tv_loss(_t(p), weight=None if weight is None else _t(weight),
                                        loss_weight=0.7))
        assert abs(got - want) < 1e-6


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"])
def test_gan_losses_match_tpuir(gan_type):
    from tpuir.train import losses as jl
    from tpuir_torch.train import losses as pl

    rng = np.random.RandomState(4)
    preds = [rng.randn(2, 4, 4, 1).astype(np.float32) * 2 for _ in range(3)]
    for real in (True, False):
        for disc in (True, False):
            kw = dict(gan_type=gan_type, is_disc=disc, loss_weight=0.3)
            want = float(jl.gan_loss(preds[0], real, **kw))
            assert abs(float(pl.gan_loss(_t(preds[0]), real, **kw)) - want) < 1e-6
            nested = [preds[0], [preds[1], preds[2]]]
            want = float(jl.multi_scale_gan_loss(nested, real, **kw))
            got = float(pl.multi_scale_gan_loss([_t(preds[0]), [_t(preds[1]), _t(preds[2])]],
                                                real, **kw))
            assert abs(got - want) < 1e-6


def test_feature_and_penalty_losses_match_tpuir():
    from tpuir.train import losses as jl
    from tpuir_torch.train import losses as pl

    rng = np.random.RandomState(5)
    feats = lambda: [[rng.randn(2, 6, 6, 4).astype(np.float32) for _ in range(3)]  # noqa: E731
                     for _ in range(2)]
    fake, real = feats(), feats()
    for crit in ("l1", "l2", "charbonnier"):
        want = float(jl.gan_feat_loss(fake, real, crit, loss_weight=2.0))
        got = float(pl.gan_feat_loss([[_t(a) for a in d] for d in fake],
                                     [[_t(a) for a in d] for d in real], crit, loss_weight=2.0))
        assert _loss_close(got, want)
    path_grad = rng.randn(3, 5, 8).astype(np.float32)
    want = [float(v) for v in jl.g_path_regularize(path_grad, 0.5)]
    got = [float(v) for v in pl.g_path_regularize(torch.from_numpy(path_grad), 0.5)]
    np.testing.assert_allclose(got, want, atol=1e-6)
    g, w = _nhwc_pair(6)
    assert _loss_close(pl.r1_penalty(_t(g)), jl.r1_penalty(g))
    for weight in (None, w):
        want = jl.gradient_penalty(g, weight)
        assert _loss_close(pl.gradient_penalty(_t(g), None if weight is None else _t(weight)),
                           want)


def test_build_loss_as_tpuir():
    from tpuir.train.losses import build_loss as jax_build
    from tpuir_torch.train.losses import build_loss

    p, t = _nhwc_pair(7)
    opt = {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}
    assert abs(float(build_loss(opt)(_t(p), _t(t))) - float(jax_build(opt)(p, t))) < 1e-6
    with pytest.raises(ValueError, match="unknown option keys"):
        build_loss({"type": "L1Loss", "bogus": 1})


@pytest.mark.parametrize("crop,y", [(0, False), (4, False), (0, True), (4, True)])
def test_metrics_bit_equal(crop, y):
    from tpuir.train import metrics as jm
    from tpuir_torch.train import metrics as pm

    rng = np.random.RandomState(0)
    a = (rng.rand(40, 44, 3) * 255).round()
    b = np.clip(a + rng.randn(40, 44, 3) * 12, 0, 255).round()
    for fn in ("calculate_psnr", "calculate_ssim"):
        opt = {"type": fn, "crop_border": crop, "test_y_channel": y}
        assert pm.calculate_metric({"img": a, "img2": b}, opt) == \
            jm.calculate_metric({"img": a, "img2": b}, opt)


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """Seeded PNG folders: 8-bit color gt and lq, gray gt, 16-bit dual-pixel."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.RandomState(0)
    for sub in ("gt", "lq", "gray", "dp_gt", "dp_l", "dp_r"):
        (root / sub).mkdir()
    for i in range(5):
        h, w = 40 + 4 * i, 36 + 2 * i
        for sub in ("gt", "lq"):
            cv2.imwrite(str(root / sub / f"{i:02d}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
        cv2.imwrite(str(root / "gray" / f"{i:02d}.png"), (rng.rand(h, w) * 255).astype(np.uint8))
        for sub in ("dp_gt", "dp_l", "dp_r"):
            cv2.imwrite(str(root / sub / f"{i}.png"),
                        (rng.rand(32, 32, 3) * 65535).astype(np.uint16))
    return root


def _dataset_opts(root):
    base = {"dataroot_gt": str(root / "gt"), "dataroot_lq": str(root / "lq"), "seed": 3}
    return {
        "paired_train": dict(base, type="PairedImageDataset", phase="train", gt_size=16,
                             use_hflip=True, use_rot=True),
        "paired_val": dict(base, type="Dataset_PairedImage", phase="val"),
        "denoise_color": dict(base, type="PairedImageDataset", task="denoising_color",
                              noise=25, phase="train", gt_size=24, geometric_augs=True),
        "denoise_val": dict(base, type="Dataset_GaussianDenoising", sigma_test=25, in_ch=3,
                            phase="val"),
        "gauss_random": dict(base, type="Dataset_GaussianDenoising", sigma_type="random",
                             sigma_range=[10, 50], in_ch=3, phase="train", gt_size=16,
                             geometric_augs=True),
        "gauss_choice_gray": dict(base, dataroot_gt=str(root / "gray"),
                                  type="Dataset_GaussianDenoising", sigma_type="choice",
                                  sigma_range=[15, 25, 50], in_ch=1, phase="train",
                                  gt_size=16),
        "dual_pixel": {"type": "Dataset_DefocusDeblur_DualPixel_16bit", "phase": "train",
                       "gt_size": 16, "geometric_augs": True, "seed": 0,
                       "dataroot_gt": str(root / "dp_gt"), "dataroot_lqL": str(root / "dp_l"),
                       "dataroot_lqR": str(root / "dp_r")},
    }


@pytest.mark.parametrize("case", ["paired_train", "paired_val", "denoise_color", "denoise_val",
                                  "gauss_random", "gauss_choice_gray", "dual_pixel"])
def test_dataset_samples_bit_equal(image_dirs, case):
    from tpuir.train.data import build_dataset as jax_build
    from tpuir_torch.train.data import build_dataset

    opt = _dataset_opts(image_dirs)[case]
    ours, theirs = build_dataset(dict(opt)), jax_build(dict(opt))
    assert len(ours) == len(theirs) == 5
    for i in (0, 3, 1, 3):
        np.random.seed(i)
        want = theirs[i]
        np.random.seed(i)
        got = ours[i]
        assert got.keys() == want.keys()
        for k in ("lq", "gt"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (case, i, k)


def test_enlarged_epoch_iterator_bit_equal(image_dirs):
    from tpuir.train.data import EnlargedEpochIterator as JaxIt, build_dataset as jax_build
    from tpuir_torch.train.data import EnlargedEpochIterator, build_dataset

    opt = _dataset_opts(image_dirs)["paired_train"]
    kw = dict(batch_size=2, shuffle=True, seed=5, enlarge_ratio=3)
    ours, theirs = EnlargedEpochIterator(build_dataset(dict(opt)), **kw), \
        JaxIt(jax_build(dict(opt)), **kw)
    assert len(ours) == len(theirs) == 7
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g["gt_path"] == w["gt_path"]
            assert np.array_equal(g["lq"], w["lq"]) and np.array_equal(g["gt"], w["gt"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
def test_mixing_augment_bit_equal(seed):
    """The port's mixup on NCHW tensors against tpuir's on NHWC arrays: the
    same draws, the same float32 arithmetic."""
    from tpuir.train.data import MixingAugment as JaxMix
    from tpuir_torch.train.data import MixingAugment

    ours, theirs = MixingAugment(1.2, True, seed=seed), JaxMix(1.2, True, seed=seed)
    for i in range(4):
        gt, lq = _nhwc_pair(10 * seed + i, (4, 6, 5, 3))
        want_gt, want_lq = theirs(gt, lq)
        got_gt, got_lq = ours(_t(gt), _t(lq))
        assert np.array_equal(got_gt.permute(0, 2, 3, 1).numpy(), want_gt)
        assert np.array_equal(got_lq.permute(0, 2, 3, 1).numpy(), want_lq)


OPTIMIZERS = {
    "adam": ({"type": "Adam", "lr": 1e-3, "betas": [0.9, 0.999]}, None, None),
    "adamw_clip_ema": ({"type": "AdamW", "lr": 3e-4, "weight_decay": 1e-4,
                        "betas": [0.9, 0.999]}, 0.01, 0.999),
    "adamw_ema": ({"type": "AdamW", "lr": 2e-3, "weight_decay": 1e-2, "betas": [0.8, 0.99]},
                  None, 0.9),
}


@functools.lru_cache(maxsize=None)
def _grads_and_params():
    rng = np.random.RandomState(8)
    params = {"w": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32),
              "k": rng.randn(2, 3, 3, 3).astype(np.float32) * 0.1}
    grads = [{k: (rng.randn(*v.shape) * (0.05 if s % 2 else 2.0)).astype(np.float32)
              for k, v in params.items()} for s in range(5)]
    return params, grads


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_steps_match_tpuir(case):
    """tpuir's train step (its optax chain, clip and EMA, through
    make_train_step with a loss whose gradient is the given one) and the
    port's TrainState.apply_gradients fed the same gradients for 5 steps,
    under the Restormer files' schedule shape: weights and EMA within 1e-6."""
    import jax.numpy as jnp
    from tpuir.train.schedulers import build_scheduler as jax_sched
    from tpuir.train.trainer import TrainState as JaxState, build_optimizer as jax_opt
    from tpuir.train.trainer import make_train_step
    from tpuir_torch.train.schedulers import build_scheduler
    from tpuir_torch.train.trainer import TrainState, build_optimizer

    optim, clip, ema = OPTIMIZERS[case]
    sched = {"type": "CosineAnnealingRestartCyclicLR", "periods": [2, 6],
             "restart_weights": [1, 1], "eta_mins": [optim["lr"], 1e-6]}
    params, grads = _grads_and_params()
    schedule = jax_sched(optim["lr"], sched)
    tx = jax_opt(optim, schedule)
    jstate = JaxState.create({k: jnp.asarray(v) for k, v in params.items()}, tx, ema)
    apply_fn = lambda p, g: sum(jnp.sum(p[k] * g[k]) for k in p)  # noqa: E731
    step = make_train_step(apply_fn, tx, lambda pred, _: pred, ema_decay=ema, grad_clip=clip)

    net = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                  for k, v in params.items()})
    state = TrainState(net, build_optimizer(optim, list(net.parameters())),
                       build_scheduler(optim["lr"], sched), ema_decay=ema)
    for g in grads:
        jstate, _ = step(jstate, {"lq": {k: jnp.asarray(v) for k, v in g.items()}, "gt": None})
        for k, p in net.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients(clip)
        for k, p in net.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                       atol=1e-6, rtol=0)
            if ema:
                np.testing.assert_allclose(state.ema[k].numpy(),
                                           np.asarray(jstate.ema_params[k]), atol=1e-6, rtol=0)
    assert state.step == int(jstate.step) == 5
