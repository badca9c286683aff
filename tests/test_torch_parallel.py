"""The port's data parallelism (``tpuir_torch/parallel/``) on the CPU, in
worlds of 2 and 3 gloo ranks spawned by ``parallel.launch`` (each world
once per module, with its own time limit).

(a) ``run_model_inference_sharded`` on tiny Restormer (tpuir's own test
shape) against tpuir's ``run_model_inference_sharded`` on the 8-device CPU
mesh, from one torch-layout state dict (tpuir's side through its
``convert_state_dict``), with and without sigma=25 AWGN: within 1 uint8
LSB; at world 3 the 8 patches are padded to 9. (b) Tiny MaIR-CDN (K6, K2,
K7's plain versions) sharded against the port's single-device engine:
within 1 LSB. (c) Two DDP steps at world 2 on B/2 each against tpuir's
``make_train_step`` on the full batch B (AdamW, the 0.01 clip, EMA): the
all-reduced gradient within 1e-5 relative L2 of tpuir's full-batch
gradient (clipped as the step clips it), the losses, weights and EMA after
each step within 1e-6 (``tests/test_torch_train_core.py``'s bound for the
single-process step). (d) ``tpuir_torch/scripts/train.py --launcher
pytorch --device cpu`` at world 2 for 2 iterations: both ranks end with
the same weights, the checkpoints are BasicSR's files, and the zoo serves
them. The rest needs no world: the environment's world, the mesh's
checks, ``batch_sharding``, ``master_only``, and a failing rank.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import InferenceModel, run_model_inference
from tpuir_torch.parallel import jobs
from tpuir_torch.parallel.dist import World, get_dist_info, master_only, world_from_env
from tpuir_torch.parallel.launch import launch
from tpuir_torch.parallel.mesh import Mesh, batch_sharding, make_mesh, shard_params_tp
from tests.torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

WORLD_TIMEOUT_S = 150  # a world's limit: spawn, torch's import, the jobs
RESTORMER_TINY = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
MAIR_TINY = dict(embed_dim=16, depths=(1, 1), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0,
                 scan_len=4)
HOOKS = dict(patch_size=32, patch_overlap=8, pad_factor=8, batch_size=2)
IMAGE = (45, 100)  # 2 x 4 tiles: 4 a rank at world 2; padded to 9, 3 a rank, at world 3
SIGMAS = (None, 25)
WORLDS = (2, 3)
# (c): the global batch, its crop, and the option file's train section
TRAIN_BATCH, TRAIN_SIDE, TRAIN_STEPS = 4, 16, 2
OPTIM = {"type": "AdamW", "lr": 3e-4, "weight_decay": 1e-4, "betas": [0.9, 0.999]}
SCHED = {"type": "CosineAnnealingRestartCyclicLR", "periods": [2, 6],
         "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
EMA, CLIP = 0.999, 0.01
GRAD_RTOL, WEIGHT_ATOL = 1e-5, 1e-6


def _image(seed=0):
    return (np.random.RandomState(seed).rand(*IMAGE, 3) * 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _restormer_sd():
    from tpuir_torch.models.restormer import init_state_dict

    return init_state_dict(RESTORMER_TINY, seed=0)


def _restormer_model():
    from tpuir_torch.models.restormer import Restormer

    net = Restormer(**RESTORMER_TINY, fused=True)
    net.load_state_dict(_restormer_sd())
    return InferenceModel(name="Restormer", net=net.eval(), device=torch.device("cpu"), **HOOKS)


@functools.lru_cache(maxsize=None)
def _mair_model():
    from tpuir_torch.models.mair import MaIR, init_state_dict

    net = MaIR(**MAIR_TINY, fused=True)
    net.load_state_dict(init_state_dict(MAIR_TINY, seed=1))
    return InferenceModel(name="MaIR", net=net.eval(), device=torch.device("cpu"), **HOOKS)


def _train_batches():
    rng = np.random.RandomState(5)
    shape = (TRAIN_STEPS, TRAIN_BATCH, TRAIN_SIDE, TRAIN_SIDE, 3)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _train_opt():
    return {"model_type": "SRModel", "is_train": True, "manual_seed": 3, "device": "cpu",
            "network_g": {"type": "MaIR", **MAIR_TINY}, "path": {},
            "train": {"ema_decay": EMA, "use_grad_clip": True, "optim_g": OPTIM,
                      "scheduler": SCHED,
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1, "reduction": "mean"}}}


TOY_TRAIN = """name: toy_ddp
model_type: SRModel
scale: 1
num_gpu: auto
manual_seed: 4
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
    batch_size_per_gpu: 1
    gt_size: 24
    dataset_enlarge_ratio: 1
network_g:
  type: DnCNN
  in_nc: 1
  out_nc: 1
  nc: 64
  nb: 17
path:
  pretrain_network_g: ~
  resume_state: ~
train:
  total_iter: 2
  use_grad_clip: true
  optim_g:
    type: AdamW
    lr: !!float 3e-4
    weight_decay: !!float 1e-4
    betas: [0.9, 0.999]
  pixel_opt:
    type: L1Loss
    loss_weight: 1
    reduction: mean
logger:
  print_freq: 1
  save_checkpoint_freq: !!float 2
  use_tb_logger: false
"""


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A toy option file (DnCNN at the zoo's gray sigma=25 width) over 4
    seeded PNGs."""
    root = tmp_path_factory.mktemp("ddp_cli")
    gt_dir = root / "gt"
    gt_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        cv2.imwrite(str(gt_dir / f"{i:02d}.png"), (rng.rand(32, 32) * 255).astype(np.uint8))
    (root / "train.yml").write_text(TOY_TRAIN.format(gt=gt_dir))
    return root


def _serve_calls():
    return (jobs.serve, ([_restormer_model(), _mair_model()],
                         [[(_image(), s) for s in SIGMAS]] * 2))


@pytest.fixture(scope="module")
def world2(cli_root):
    """World 2: sharded serving, two DDP steps, the training script."""
    lq, gt = _train_batches()
    argv = ["-opt", str(cli_root / "train.yml"), "--launcher", "pytorch", "--device", "cpu"]
    calls = [_serve_calls(), (jobs.train_steps, (_train_opt(), lq, gt, TRAIN_STEPS)),
             (jobs.train_script, (argv, str(cli_root)))]
    return launch(jobs.several, 2, args=(calls,), device="cpu", threads=1,
                  timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def world3():
    """World 3: sharded serving."""
    return launch(jobs.several, 3, args=([_serve_calls()],), device="cpu", threads=1,
                  timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def worlds(world2, world3):
    return {2: world2, 3: world3}


def _lsb(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return int(np.abs(got.astype(int) - want.astype(int)).max())


@functools.lru_cache(maxsize=None)
def _tpuir_restormer(sigma):
    """tpuir's run_model_inference_sharded on its 8-device CPU mesh."""
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.models import restormer as jres
    from tpuir.parallel.inference import run_model_inference_sharded
    from tpuir.parallel.mesh import make_mesh as jax_mesh

    params = jres.convert_state_dict({k: v.numpy() for k, v in _restormer_sd().items()},
                                     (1, 1, 1, 1), 1, False, True, False)
    model = JaxInferenceModel(name="Restormer", apply_fn=jres.Restormer(**RESTORMER_TINY).apply,
                              params=params, **HOOKS)
    out, _ = run_model_inference_sharded(model, _image(), jax_mesh({"dp": 8}),
                                         need_degradation=sigma is not None, noise_level=sigma)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_sharded_restormer_matches_tpuir(worlds, world, sigma):
    got = worlds[world][0][0]["outputs"][0][SIGMAS.index(sigma)]
    assert _lsb(got, _tpuir_restormer(sigma)) <= 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_sharded_mair_matches_single_device(worlds, world, sigma):
    want, _ = run_model_inference(_mair_model(), _image(), need_degradation=sigma is not None,
                                  noise_level=sigma)
    got = worlds[world][0][0]["outputs"][1][SIGMAS.index(sigma)]
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_whole_image(worlds, world):
    outs = [rank[0]["outputs"] for rank in worlds[world]]
    for other in outs[1:]:
        for a, b in zip(sum(outs[0], []), sum(other, [])):
            assert np.array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _tpuir_train():
    """tpuir's make_train_step on the full batches: per step the loss, the
    clipped gradient the optimizer took, the weights and the EMA after it,
    as flat {path: array}; and the converter of the port's state dicts."""
    import jax
    import jax.numpy as jnp
    from tpuir.models import mair as jm
    from tpuir.train.schedulers import build_scheduler
    from tpuir.train.trainer import TrainState, build_optimizer, make_train_step
    from tpuir_torch.train.archs import init_state_dict

    sd = init_state_dict({"type": "MaIR", **MAIR_TINY}, seed=_train_opt()["manual_seed"])
    convert = functools.partial(jm.convert_state_dict, depths=MAIR_TINY["depths"],
                                embed_dim=MAIR_TINY["embed_dim"],
                                ssm_ratio=MAIR_TINY["ssm_ratio"])
    apply = jm.MaIR(**MAIR_TINY, scan_chunk=64).apply
    tx = build_optimizer(OPTIM, build_scheduler(OPTIM["lr"], SCHED))
    loss_fn = lambda pred, gt: jnp.mean(jnp.abs(pred - gt))  # noqa: E731
    state = TrainState.create(convert({k: v.numpy() for k, v in sd.items()}), tx, EMA)
    step = jax.jit(make_train_step(apply, tx, loss_fn, ema_decay=EMA, grad_clip=CLIP))
    grad_of = jax.jit(jax.grad(lambda p, x, y: loss_fn(apply(p, x), y)))
    out = {"loss": [], "grads": [], "params": [], "ema": []}
    for x, y in zip(*_train_batches()):
        g = grad_of(state.params, x, y)
        scale = min(1.0, CLIP / (float(jax.tree_util.tree_reduce(
            lambda a, b: a + b, jax.tree_util.tree_map(lambda t: jnp.sum(t * t), g))) ** 0.5
            + 1e-6))
        state, metrics = step(state, {"lq": jnp.asarray(x), "gt": jnp.asarray(y)})
        out["loss"].append(float(metrics["loss"]))
        out["grads"].append(_leaves(jax.tree_util.tree_map(lambda t: t * scale, g)))
        out["params"].append(_leaves(state.params))
        out["ema"].append(_leaves(state.ema_params))
    return out, convert


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def test_ddp_losses_match_tpuirs_full_batch(world2):
    want, _ = _tpuir_train()
    for rank in world2:
        got = rank[1]["loss"]
        assert len(got) == TRAIN_STEPS
        for g, w in zip(got, want["loss"]):
            assert abs(g - w) <= WEIGHT_ATOL * max(1.0, abs(w)), (g, w)


@pytest.mark.parametrize("step", range(TRAIN_STEPS))
def test_ddp_gradient_is_tpuirs_full_batch_gradient(world2, step):
    """The all-reduced (averaged) gradient of the two half batches, as the
    optimizer took it, against tpuir's full-batch gradient: relative L2 over
    every parameter; the two ranks' gradients equal."""
    want, convert = _tpuir_train()
    got = [_leaves(convert(rank[1]["grads"][step])) for rank in world2]
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k
    w = want["grads"][step]
    assert got[0].keys() == w.keys()
    err = np.sqrt(sum(np.sum((got[0][k] - w[k]) ** 2) for k in w))
    norm = np.sqrt(sum(np.sum(w[k] ** 2) for k in w))
    assert err <= GRAD_RTOL * norm, (err, norm)


@pytest.mark.parametrize("step", range(TRAIN_STEPS))
@pytest.mark.parametrize("what", ["params", "ema"])
def test_ddp_weights_match_tpuirs_full_batch_step(world2, step, what):
    want, convert = _tpuir_train()
    for rank in world2:
        got = _leaves(convert(rank[1][what][step]))
        assert got.keys() == want[what][step].keys()
        for k, w in want[what][step].items():
            np.testing.assert_allclose(got[k], w, atol=WEIGHT_ATOL, rtol=0, err_msg=k)


def test_train_script_under_the_pytorch_launcher(world2, cli_root, tmp_path):
    """Both ranks ran 2 iterations to the same weights; rank 0's checkpoints
    are BasicSR's files, and the zoo serves the trained network from them
    (its DnCNN files are KAIR's bare state dicts: the ``params`` entry)."""
    from tpuir_torch import zoo
    from tpuir_torch.train.model import load_params

    runs = [rank[2] for rank in world2]
    assert [r["rank"] for r in runs] == [0, 1] and [r["iter"] for r in runs] == [2, 2]
    for k, v in runs[0]["params"].items():
        assert np.array_equal(v, runs[1]["params"][k]), k
    exp = cli_root / "experiments" / "toy_ddp"
    assert sorted(os.listdir(exp / "models")) == ["net_g_2.pth"]
    assert sorted(os.listdir(exp / "training_states")) == ["2.state"]
    sd = load_params(str(exp / "models" / "net_g_2.pth"))
    assert all(np.array_equal(sd[k].numpy(), v) for k, v in runs[0]["params"].items())
    (tmp_path / "DnCNN").mkdir()
    torch.save(sd, tmp_path / "DnCNN" / "dncnn_25.pth")
    model = zoo.get_model_instance("denoising", "gaussian", "DnCNN", gray=True, sigma=25,
                                   weights_dir=str(tmp_path), device="cpu")
    for k, v in runs[0]["params"].items():
        assert np.array_equal(model.net.state_dict()[k].numpy(), v), k


def test_a_failing_rank_fails_the_launch():
    """A rank's exception fails the launch with its traceback."""
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*does not split"):
        launch(jobs.several, 2, args=([(batch_sharding, (Mesh({"dp": 2}, 1), 3))],),
               device="cpu", threads=1, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("env,want", [
    ({}, World(0, 1, 0, None)),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
      "MASTER_PORT": "1"}, World(3, 4, 1, "env://")),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1", "MASTER_ADDR": "h",
      "MASTER_PORT": "7"}, World(5, 8, 1, "tcp://h:7")),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "2"}, World(0, 2, 0, "tcp://localhost:29500")),
], ids=["alone", "torchrun", "slurm", "slurm_defaults"])
def test_world_from_env(env, want):
    assert world_from_env(env) == want


def test_a_process_alone_is_rank_0_of_1():
    assert get_dist_info() == (0, 1)
    mesh = make_mesh()
    assert mesh.axes == {"dp": 1} and mesh.host_group is None
    x = np.arange(6.0).reshape(3, 2)
    from tpuir_torch.parallel.inference import gather_patches

    assert gather_patches(x, mesh) is x


@pytest.mark.parametrize("axes", [{"dp": 1, "sp": 1}, {"tp": 1}])
def test_mesh_refuses_the_axes_not_ported(axes):
    with pytest.raises(NotImplementedError, match="Tensor and spatial parallelism"):
        make_mesh(axes)


def test_mesh_checks_the_world_and_tp_placement_is_not_ported():
    with pytest.raises(ValueError, match="does not match 1 processes"):
        make_mesh({"dp": 2})
    with pytest.raises(NotImplementedError, match="Tensor and spatial parallelism"):
        shard_params_tp({}, make_mesh())


def test_batch_sharding_gives_contiguous_equal_shares():
    shares = [batch_sharding(Mesh({"dp": 3}, r), 12) for r in range(3)]
    assert shares == [slice(0, 4), slice(4, 8), slice(8, 12)]
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(Mesh({"dp": 3}, 0), 10)


def test_master_only_runs_on_rank_0_alone(monkeypatch):
    from tpuir_torch.parallel import dist as pdist
    from tpuir_torch.train.model import SRModel

    calls = []
    f = master_only(lambda: calls.append(1) or "done")
    assert f() == "done" and calls == [1]
    monkeypatch.setattr(pdist, "get_dist_info", lambda: (1, 2))
    assert f() is None and calls == [1]
    assert SRModel.save.__wrapped__  # the checkpoint writer is master_only


def test_replicate_broadcasts_every_tensor_from_rank_0(monkeypatch):
    """``replicate`` sends each parameter and buffer from rank 0 (the
    broadcast stands in for the group's); a mesh of one sends nothing."""
    from tpuir_torch.parallel import mesh as pmesh

    net = torch.nn.BatchNorm2d(3)
    sent = []

    def broadcast(t, src):
        sent.append(src)
        t.fill_(7.0)

    monkeypatch.setattr(pmesh.dist, "broadcast", broadcast)
    assert pmesh.replicate(net, Mesh({"dp": 1}, 0)) is net and not sent
    pmesh.replicate(net, Mesh({"dp": 2}, 1))
    assert sent == [0] * 5  # weight, bias, running mean and variance, batch count
    assert all(bool((t == 7).all()) for t in net.state_dict().values())


def test_init_dist_refuses_what_cannot_run():
    """NCCL on the CPU, and a card where torch finds none, raise: no
    fallback to gloo or to the CPU."""
    from tpuir_torch.parallel.dist import init_dist

    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        init_dist("nccl", 0, 2, init_method="file:///nowhere", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_dist(rank=0, world_size=2, init_method="file:///nowhere")
    assert get_dist_info() == (0, 1)
