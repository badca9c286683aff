"""The port's training pipeline on the CPU: tpuir's own pipeline tests
(``tests/test_train_framework.py``: a tiny DnCNN end to end, resume, a
saved checkpoint reproducing the model's outputs) on ``tpuir_torch``, the
progressive crop on NCHW tensors against tpuir's on NHWC arrays, the
device rule, the model wrappers' ``test`` (x8 for MaIRPlusModel),
``pad_test`` and ``tile_test`` against tpuir's within 1e-5, and
``tpuir_torch/scripts/{train,test,testM}.py`` on a toy option file.
"""

import os

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")


@pytest.fixture()
def train_env(tmp_path):
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        cv2.imwrite(str(gt_dir / f"{i:02d}.png"), (rng.rand(48, 48) * 255).astype(np.uint8))
    return tmp_path, str(gt_dir)


def _train_opt(root, gt_dir, total_iter=20):
    """tpuir's toy option dict (``tests/test_train_framework.py:_train_opt``)
    on the CPU."""
    from tests.test_train_framework import _train_opt as tpuir_opt

    opt = tpuir_opt(root, gt_dir, total_iter)
    opt["device"] = "cpu"
    return opt


def test_train_pipeline_end_to_end(train_env):
    from tpuir_torch.train.data import EnlargedEpochIterator, build_dataset
    from tpuir_torch.train.pipeline import train_pipeline

    root, gt_dir = train_env
    opt = _train_opt(root, gt_dir, total_iter=20)
    result = train_pipeline(str(root), opt)
    assert result["iter"] == 20
    for name in ("net_g_20.pth", "net_g_ema_20.pth"):
        assert os.path.exists(root / "models" / name)
    assert os.path.exists(root / "states" / "20.state")
    val_ds = build_dataset(opt["datasets"]["val"])
    metrics = result["model"].validation(
        EnlargedEpochIterator(val_ds, 1, shuffle=False, drop_last=False))
    assert 5 < metrics["psnr"] < 60 and 0 < metrics["ssim"] <= 1


def test_resume_training(train_env):
    from tpuir_torch.train.pipeline import train_pipeline

    root, gt_dir = train_env
    first = train_pipeline(str(root), _train_opt(root, gt_dir, total_iter=10))["model"]
    opt2 = _train_opt(root, gt_dir, total_iter=14)
    opt2["auto_resume"] = True
    result = train_pipeline(str(root), opt2)
    assert result["iter"] == 14
    assert result["model"].state.step == 14
    # the resumed run started from the saved state: the optimizer's step count
    # is the first run's plus four
    opt_state = result["model"].state.optimizer.state_dict()["state"]
    first_state = first.state.optimizer.state_dict()["state"]
    assert float(opt_state[0]["step"]) == float(first_state[0]["step"]) + 4


def test_loaded_checkpoint_reproduces_outputs(train_env):
    from tpuir_torch.train.archs import build_network
    from tpuir_torch.train.model import load_params
    from tpuir_torch.train.pipeline import train_pipeline

    root, gt_dir = train_env
    opt = _train_opt(root, gt_dir, total_iter=10)
    model = train_pipeline(str(root), opt)["model"]
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 1, 16, 16).astype(np.float32))
    with torch.no_grad():
        want = model.net_g(x)
        net = build_network(opt["network_g"])
        net.load_state_dict(load_params(str(root / "models" / "net_g_10.pth")))
        assert torch.equal(net(x), want)


def test_progressive_crop_lands_on_tpuirs_pixels():
    """The NCHW crop of the port's ProgressiveSchedule takes the pixels
    tpuir's NHWC crop takes, and the same samples, stage by stage."""
    from tpuir.train.pipeline import ProgressiveSchedule as JaxSchedule
    from tpuir_torch.train.pipeline import ProgressiveSchedule

    ds_opt = {"iters": [2, 3, 4], "mini_batch_sizes": [4, 3, 2], "gt_sizes": [8, 12, 16],
              "gt_size": 16, "batch_size_per_gpu": 4}
    ours, theirs = ProgressiveSchedule(ds_opt, seed=5), JaxSchedule(ds_opt, seed=5)
    rng = np.random.RandomState(0)
    for it in range(1, 10):
        lq, gt = (rng.rand(4, 16, 16, 3).astype(np.float32) for _ in range(2))
        want = theirs({"lq": lq, "gt": gt}, it)
        got = ours({"lq": torch.from_numpy(lq).permute(0, 3, 1, 2),
                    "gt": torch.from_numpy(gt).permute(0, 3, 1, 2)}, it)
        for k in ("lq", "gt"):
            assert np.array_equal(got[k].permute(0, 2, 3, 1).numpy(), want[k]), (it, k)


def test_build_model_takes_the_card_unless_asked(train_env):
    from tpuir_torch.train.model import build_model

    root, gt_dir = train_env
    opt = _train_opt(root, gt_dir)
    del opt["device"]
    if torch.cuda.is_available():
        assert build_model(opt).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(opt)
    assert build_model(opt, device="cpu").device == torch.device("cpu")


TOY_TRAIN = """name: toy
model_type: ImageCleanModel
scale: 1
num_gpu: auto
manual_seed: 3
datasets:
  train:
    name: toy
    type: Dataset_GaussianDenoising
    sigma_type: constant
    sigma_range: 25
    in_ch: 1
    dataroot_gt: {gt}
    dataroot_lq: none
    geometric_augs: true
    use_shuffle: true
    batch_size_per_gpu: 2
    mini_batch_sizes: [2, 1]
    iters: [3, 3]
    gt_size: 32
    gt_sizes: [16, 32]
    dataset_enlarge_ratio: 1
  val:
    name: toyval
    type: Dataset_GaussianDenoising
    sigma_test: 25
    in_ch: 1
    dataroot_gt: {gt}
    dataroot_lq: none
network_g:
  type: DnCNN
  in_nc: 1
  out_nc: 1
  nc: 8
  nb: 4
path:
  pretrain_network_g: ~
  resume_state: ~
train:
  total_iter: 6
  use_grad_clip: true
  scheduler:
    type: CosineAnnealingRestartCyclicLR
    periods: [3, 3]
    restart_weights: [1, 1]
    eta_mins: [0.0003, 0.000001]
  mixing_augs:
    mixup: true
    mixup_beta: 1.2
    use_identity: true
  optim_g:
    type: AdamW
    lr: !!float 3e-4
    weight_decay: !!float 1e-4
    betas: [0.9, 0.999]
  pixel_opt:
    type: L1Loss
    loss_weight: 1
    reduction: mean
val:
  window_size: 8
  val_freq: !!float 3
  use_image: false
  metrics:
    psnr:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: false
logger:
  print_freq: 2
  save_checkpoint_freq: !!float 3
  use_tb_logger: false
"""

TOY_TEST = """name: toytest
model_type: SRModel
scale: 1
manual_seed: 3
datasets:
  test_1:
    name: toyval
    type: Dataset_GaussianDenoising
    sigma_test: 25
    in_ch: 1
    dataroot_gt: {gt}
    dataroot_lq: none
network_g:
  type: DnCNN
  in_nc: 1
  out_nc: 1
  nc: 8
  nb: 4
path:
  pretrain_network_g: {ckpt}
  param_key_g: params
val:
  window_size: 8
  metrics:
    psnr:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: false
"""


def test_train_test_and_testm_scripts(train_env):
    """train.py on a toy option file (progressive stages, mixup, the clip,
    periodic checkpoints), test.py on its last checkpoint, testM.py over
    every checkpoint: the test script's PSNR is testM's at that iteration."""
    from tpuir_torch.scripts import test as test_script, testM, train

    root, gt_dir = train_env
    (root / "train.yml").write_text(TOY_TRAIN.format(gt=gt_dir))
    result = train.main(["-opt", str(root / "train.yml"), "--device", "cpu"], root_path=str(root))
    assert result["iter"] == 6
    models = root / "experiments" / "toy" / "models"
    assert sorted(os.listdir(models)) == ["net_g_3.pth", "net_g_6.pth"]
    assert sorted(os.listdir(root / "experiments" / "toy" / "training_states")) == \
        ["3.state", "6.state"]
    (root / "test.yml").write_text(TOY_TEST.format(gt=gt_dir, ckpt=models / "net_g_6.pth"))
    scores = test_script.main(["-opt", str(root / "test.yml"), "--device", "cpu"],
                              root_path=str(root))
    sweep = testM.main(["-opt", str(root / "test.yml"), "--models-dir", str(models),
                        "--device", "cpu"], root_path=str(root))
    assert sorted(sweep) == [3, 6]
    assert sweep[6]["toyval"]["psnr"] == scores["toyval"]["psnr"]
    assert sweep[3]["toyval"]["psnr"] != sweep[6]["toyval"]["psnr"]
    assert sorted(testM.main(["-opt", str(root / "test.yml"), "--models-dir", str(models),
                              "--step", "6", "--device", "cpu"], root_path=str(root))) == [6]


@pytest.mark.parametrize("model_type", ["SRModel", "MambaIRModel", "MaIRPlusModel"])
def test_model_wrappers_match_tpuir(tmp_path, model_type):
    """The same released-format ``.pth`` through both packages' wrappers:
    ``test`` (MaIRPlusModel: the x8 rotations and flips), ``pad_test`` and
    MambaIRModel's ``tile_test`` through each package's engine."""
    from tpuir.train.model import build_model as jax_build
    from tpuir_torch.train.archs import init_state_dict
    from tpuir_torch.train.model import build_model

    net = {"type": "DnCNN", "in_nc": 1, "out_nc": 1, "nc": 8, "nb": 4}
    path = tmp_path / "net.pth"
    torch.save({"params": init_state_dict(net, seed=4)}, path)
    opt = {"model_type": model_type, "network_g": net, "manual_seed": 0,
           "path": {"pretrain_network_g": str(path)}}
    ours, theirs = build_model(dict(opt), device="cpu"), jax_build(dict(opt))
    lq = np.random.RandomState(5).rand(2, 13, 10, 1).astype(np.float32)
    x = torch.from_numpy(lq).permute(0, 3, 1, 2)
    np.testing.assert_allclose(ours.test(x).permute(0, 2, 3, 1).numpy(), theirs.test(lq),
                               atol=1e-5)
    np.testing.assert_allclose(ours.pad_test(x, 8).permute(0, 2, 3, 1).numpy(),
                               theirs.pad_test(lq, 8), atol=1e-5)
    if model_type == "MambaIRModel":
        img = np.random.RandomState(6).rand(3, 40, 30, 1).astype(np.float32)
        np.testing.assert_allclose(ours.tile_test(img, tile=16), theirs.tile_test(img, tile=16),
                                   atol=1e-5)
