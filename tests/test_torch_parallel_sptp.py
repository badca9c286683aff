"""The port's spatial and tensor parallelism (tpuir's ``sp`` and ``tp``
mesh axes, ``shard_params_tp``, ``dryrun_multichip``'s steps) on the CPU, in
worlds of 2 and 4 gloo ranks spawned by ``parallel.launch`` (all started
together once per module, beside tpuir's reference).

(a) In worlds ``{sp: 2}``, ``{tp: 2}`` and ``{dp: 1, sp: 2, tp: 2}``,
``parallel.dryrun``'s tiny Restormer, MaIR and MaIRUNet (tpuir's
``dryrun_multichip`` shapes, batch 2, 32x32; wide parameters over ``tp``
at ``min_dim`` 64) take two steps, each held to tpuir's single-device
``make_train_step`` on the full batch from the same torch-layout state
dict (tpuir's side through its ``convert_state_dict``): the loss within
1e-5 relative, the averaged and clipped gradient within 1e-5 relative L2
a tensor (``GRAD_RTOL``), the weights and EMA within 1e-6
(``WEIGHT_ATOL``); every rank
holds the same whole state. (b) ``shard_params_tp`` shards the parameters
that tpuir's gives a ``"tp"`` sharding, for the three models at full width
and ``min_dim`` 64 and 128, and ``full_state_dict`` gives the unsharded
weights back. (c) The halo convs, MDTA's sums and the mixer on the gathered
rows, forward and backward, against the unsharded modules. (d) Sharded
inference on the 3-axis mesh within 1 LSB of tpuir's on its 8-device mesh,
and on ``{dp: 1, tp: 2}`` both ranks serve the whole grid. (e) With every
axis 1, the step is ``train/trainer.py``'s, bit for bit.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from tests import torch_mesh_jobs
from tests.torch_threads import one_torch_thread  # noqa: F401
from tpuir_torch.core.engine import InferenceModel
from tpuir_torch.parallel import dryrun, jobs
from tpuir_torch.parallel.inference import dp_share
from tpuir_torch.parallel.launch import launch
from tpuir_torch.parallel.mesh import Mesh, volume

WORLD_TIMEOUT_S = 200
STEPS, BATCH, SIDE, MIN_DIM = 2, 2, 32, 64
LOSS_RTOL, GRAD_RTOL, WEIGHT_ATOL = 1e-5, 1e-5, 1e-6
NETWORKS = {  # dryrun_multichip's tiny models, with their seeds
    "Restormer": ({"type": "Restormer", "dim": 16, "num_blocks": [1, 1, 1, 1],
                   "num_refinement_blocks": 1}, 0),
    "MaIR": ({"type": "MaIR", "embed_dim": 16, "depths": [1, 1], "d_state": 4,
              "ssm_ratio": 1.5, "mlp_ratio": 2.0}, 1),
    "MaIRUNet": ({"type": "MaIRUNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
                  "num_refinement_blocks": 1}, 3),
}
FULL_WIDTH = {  # the released widths, one block a level or group
    "Restormer": {"type": "Restormer", "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
                  "LayerNorm_type": "BiasFree"},
    "MaIR": {"type": "MaIR", "embed_dim": 180, "depths": [1], "d_state": 16, "ssm_ratio": 1.3},
    "MaIRUNet": {"type": "MaIRUNet", "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1},
}
WORLDS = {"sp": {"sp": 2}, "tp": {"tp": 2}, "dp_sp_tp": {"dp": 1, "sp": 2, "tp": 2}}
RESTORMER_TINY = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
HOOKS = dict(patch_size=32, patch_overlap=8, pad_factor=8, batch_size=2)
IMAGE = (45, 100)  # 2 x 4 tiles


def _batches():
    rng = np.random.RandomState(24)
    shape = (STEPS, BATCH, SIDE, SIDE, 3)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _trains():
    lq, gt = _batches()
    return [{"network_g": net, "seed": seed, "lq": lq, "gt": gt, "min_dim": MIN_DIM}
            for net, seed in NETWORKS.values()]


def _image():
    return (np.random.RandomState(0).rand(*IMAGE, 3) * 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _restormer_sd():
    from tpuir_torch.models.restormer import init_state_dict

    return init_state_dict(RESTORMER_TINY, seed=0)


def _restormer_model():
    from tpuir_torch.models.restormer import Restormer

    net = Restormer(**RESTORMER_TINY, fused=True)
    net.load_state_dict(_restormer_sd())
    return InferenceModel(name="Restormer", net=net.eval(), device=torch.device("cpu"), **HOOKS)


def _serving():
    return ([_restormer_model()], [[(_image(), None)]])


def _world_calls():
    trains = _trains()
    return {
        "sp": [(dryrun.dryrun_multichip, (WORLDS["sp"], trains)),
               (torch_mesh_jobs.spatial_layers, (WORLDS["sp"],))],
        "tp": [(dryrun.dryrun_multichip, (WORLDS["tp"], trains)),
               (dryrun.dryrun_multichip, ({"dp": 1, "tp": 2}, [], None, _serving())),
               (torch_mesh_jobs.sharded_state,
                (WORLDS["tp"], NETWORKS["MaIRUNet"][0], NETWORKS["MaIRUNet"][1], MIN_DIM))],
        "dp_sp_tp": [(dryrun.dryrun_multichip, (WORLDS["dp_sp_tp"], trains, None, _serving())),
                     (torch_mesh_jobs.sharded_state,
                      (WORLDS["dp_sp_tp"], NETWORKS["Restormer"][0], NETWORKS["Restormer"][1],
                       MIN_DIM))],
    }


@pytest.fixture(scope="module")
def worlds():
    """Every world at once, in threads, while this process runs tpuir's
    steps: {world: [each rank's results of its calls]}."""
    calls = _world_calls()
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        pending = {name: pool.submit(launch, jobs.several, volume(WORLDS[name]), args=(c,),
                                     device="cpu", threads=1, timeout=WORLD_TIMEOUT_S)
                   for name, c in calls.items()}
        for name in NETWORKS:
            _tpuir_steps(name)
        return {name: p.result() for name, p in pending.items()}


def _converter(name):
    from tpuir.models import mair as jm, mair_unet as ju, restormer as jr

    net = dict(NETWORKS[name][0])
    if name == "Restormer":
        return functools.partial(jr.convert_state_dict, num_blocks=tuple(net["num_blocks"]),
                                 num_refinement_blocks=net["num_refinement_blocks"])
    if name == "MaIR":
        return functools.partial(jm.convert_state_dict, depths=tuple(net["depths"]),
                                 embed_dim=net["embed_dim"], ssm_ratio=net["ssm_ratio"])
    return functools.partial(ju.convert_state_dict, dim=net["dim"],
                             num_blocks=tuple(net["num_blocks"]),
                             num_refinement_blocks=net["num_refinement_blocks"])


def _jax_model(name):
    from tpuir.models import mair as jm, mair_unet as ju, restormer as jr

    net = dict(NETWORKS[name][0])
    if name == "Restormer":
        return jr.Restormer(dim=net["dim"], num_blocks=tuple(net["num_blocks"]),
                            num_refinement_blocks=net["num_refinement_blocks"])
    if name == "MaIR":
        return jm.MaIR(embed_dim=net["embed_dim"], depths=tuple(net["depths"]),
                       d_state=net["d_state"], ssm_ratio=net["ssm_ratio"],
                       mlp_ratio=net["mlp_ratio"], scan_chunk=64)
    return ju.MaIRUNet(dim=net["dim"], num_blocks=tuple(net["num_blocks"]),
                       num_refinement_blocks=net["num_refinement_blocks"], scan_chunk=64)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


@functools.lru_cache(maxsize=None)
def _tpuir_steps(name):
    """tpuir's make_train_step on the full batches (dryrun_multichip's
    optimizer, schedule, clip and EMA): per step the loss, the clipped
    gradient, the weights and the EMA after it, as flat {path: array}."""
    import jax
    import jax.numpy as jnp
    from tpuir.train.schedulers import build_scheduler
    from tpuir.train.trainer import TrainState, build_optimizer, make_train_step
    from tpuir_torch.train.archs import init_state_dict

    net, seed = NETWORKS[name]
    sd = init_state_dict(net, seed)
    apply = _jax_model(name).apply
    tx = build_optimizer(dryrun.OPTIM, build_scheduler(dryrun.OPTIM["lr"], dryrun.SCHEDULE))
    loss_fn = lambda pred, gt: jnp.mean(jnp.abs(pred - gt))  # noqa: E731
    state = TrainState.create(_converter(name)({k: v.numpy() for k, v in sd.items()}), tx,
                              dryrun.EMA_DECAY)
    step = make_train_step(apply, tx, loss_fn, ema_decay=dryrun.EMA_DECAY,
                           grad_clip=dryrun.GRAD_CLIP)

    @jax.jit
    def grad_and_step(state, x, y):  # one program: half the compile of two
        g = jax.grad(lambda p: loss_fn(apply(p, x), y))(state.params)
        return (g,) + step(state, {"lq": x, "gt": y})

    out = {"loss": [], "grads": [], "params": [], "ema": []}
    for x, y in zip(*_batches()):
        g, state, metrics = grad_and_step(state, jnp.asarray(x), jnp.asarray(y))
        norm = float(jnp.sqrt(sum(jnp.sum(t * t) for t in jax.tree_util.tree_leaves(g))))
        scale = min(1.0, dryrun.GRAD_CLIP / (norm + 1e-6))
        out["loss"].append(float(metrics["loss"]))
        out["grads"].append(_leaves(jax.tree_util.tree_map(lambda t: t * scale, g)))
        out["params"].append(_leaves(state.params))
        out["ema"].append(_leaves(state.ema_params))
    return out


def _run(worlds, world, model):
    """Each rank's train part of ``model`` in ``world``."""
    i = list(NETWORKS).index(model)
    return [rank[0]["train"][i] for rank in worlds[world]]


CASES = [(w, m) for w in WORLDS for m in NETWORKS]


@pytest.mark.parametrize("world,model", CASES)
def test_losses_match_tpuirs_full_batch_step(worlds, world, model):
    want = _tpuir_steps(model)["loss"]
    for rank in _run(worlds, world, model):
        for got, w in zip(rank["loss"], want):
            assert abs(got - w) <= LOSS_RTOL * abs(w), (got, w)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("world,model", CASES)
def test_gradient_is_tpuirs_full_batch_gradient(worlds, world, model, step):
    """The averaged, clipped gradient the optimizer took, gathered whole,
    against tpuir's full-batch gradient: relative L2 a tensor; every rank
    took the same."""
    runs = _run(worlds, world, model)
    assert len({r["digests"][step]["grads"] for r in runs}) == 1
    got = _leaves(_converter(model)(runs[0]["grads"][step]))
    want = _tpuir_steps(model)["grads"][step]
    assert got.keys() == want.keys()
    for k, w in want.items():
        err, norm = np.linalg.norm(got[k] - w), np.linalg.norm(w)
        assert err <= GRAD_RTOL * norm, (k, err, norm)


@pytest.mark.parametrize("what", ["params", "ema"])
@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("world,model", CASES)
def test_weights_match_tpuirs_full_batch_step(worlds, world, model, step, what):
    runs = _run(worlds, world, model)
    assert len({r["digests"][step][what] for r in runs}) == 1  # every rank holds the same
    got = _leaves(_converter(model)(runs[0][what][step]))
    want = _tpuir_steps(model)[what][step]
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=WEIGHT_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_cpu_steps_launch_no_kernel(worlds, world):
    """On the CPU the wrappers take their plain versions and count nothing:
    the steps of every world launch no kernel here (the card's counts are
    ``chip_smoke.py`` phase 22's)."""
    for model in ("MaIR", "MaIRUNet"):
        for rank in _run(worlds, world, model):
            assert not any(rank["launches"].values())
            assert len(rank["loss"]) == STEPS


def _jax_sharded_leaves(name, min_dim):
    """The torch names of the parameters to which tpuir's shard_params_tp
    gives a "tp" sharding on its 8-device mesh (``dryrun_multichip``'s),
    for the ``FULL_WIDTH`` model ``name``: a state dict of ones where tpuir
    shards and zeros elsewhere, through tpuir's converter and back through
    the port's ``state_dict_from_jax``."""
    import jax
    from tpuir.models import mair as jm, mair_unet as ju, restormer as jr
    from tpuir.parallel.mesh import make_mesh, shard_params_tp
    from tpuir_torch.models import mair, mair_unet, restormer
    from tpuir_torch.train.archs import build_network

    net = FULL_WIDTH[name]
    sd = {k: v.detach().numpy() for k, v in build_network(net).state_dict().items()}
    if name == "Restormer":
        params = jr.convert_state_dict(sd, tuple(net["num_blocks"]), 1, False, False)
        back = restormer.state_dict_from_jax
    elif name == "MaIR":
        params = jm.convert_state_dict(sd, net["depths"], net["embed_dim"], net["ssm_ratio"])
        back = mair.state_dict_from_jax
    else:
        params = ju.convert_state_dict(sd, num_blocks=tuple(net["num_blocks"]),
                                       num_refinement_blocks=1)
        back = mair_unet.state_dict_from_jax
    placed = shard_params_tp(params, make_mesh(dryrun.mesh_axes(8), jax.devices()[:8]),
                             min_dim=min_dim)
    marks = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float("tp" in tuple(x.sharding.spec)), np.float32), placed)
    return {k for k, v in back(marks).items() if v.numel() and bool((v == 1).all())}


@pytest.mark.parametrize("min_dim", [64, 128])
@pytest.mark.parametrize("model", list(FULL_WIDTH))
def test_shard_params_tp_shards_what_tpuir_shards(model, min_dim):
    from tpuir_torch.parallel.tensor import tp_leaves
    from tpuir_torch.train.archs import build_network

    with torch.device("meta"):
        net = build_network(FULL_WIDTH[model])
    got = set(tp_leaves(net, dryrun.mesh_axes(8)["tp"], min_dim))
    want = _jax_sharded_leaves(model, min_dim)
    assert want and got == want, (sorted(got ^ want)[:8])


@pytest.mark.parametrize("world,model,call", [("tp", "MaIRUNet", 2),
                                              ("dp_sp_tp", "Restormer", 1)])
def test_full_state_dict_is_the_unsharded_weights(worlds, world, model, call):
    from tpuir_torch.train.archs import init_state_dict

    net, seed = NETWORKS[model]
    want = init_state_dict(net, seed)
    for rank in worlds[world]:
        got = rank[call]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v.numpy()), k


@pytest.mark.parametrize("layer", ["conv", "depthwise", "mdta", "mixer"])
def test_spatial_layers_match_the_unsharded_module(worlds, layer):
    """Forward, input gradient and parameter gradients of each layer split
    over two ranks' rows, against the unsharded module on the whole image:
    the halo rows' gradients go back to their owner, MDTA's sums are
    all-reduced both ways, the mixer's gathered rows reduce-scatter."""
    layers, x, w = torch_mesh_jobs.seeded_layers()
    y, gx, gp = torch_mesh_jobs.run_layer(layer, layers[layer], x, w)
    for rank in worlds["sp"]:
        got_y, got_gx, got_gp = rank[1][layer]
        np.testing.assert_allclose(got_y, y.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_gx, gx.numpy(), atol=1e-5, rtol=1e-5)
        for k, g in gp.items():
            np.testing.assert_allclose(got_gp[k], g.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


@functools.lru_cache(maxsize=None)
def _tpuir_sharded_restormer():
    from tpuir.core.engine import InferenceModel as JaxInferenceModel
    from tpuir.models import restormer as jres
    from tpuir.parallel.inference import run_model_inference_sharded
    from tpuir.parallel.mesh import make_mesh as jax_mesh

    params = jres.convert_state_dict({k: v.numpy() for k, v in _restormer_sd().items()},
                                     (1, 1, 1, 1), 1, False, True, False)
    model = JaxInferenceModel(name="Restormer", apply_fn=jres.Restormer(**RESTORMER_TINY).apply,
                              params=params, **HOOKS)
    out, _ = run_model_inference_sharded(model, _image(), jax_mesh(dryrun.mesh_axes(8)))
    return out


@pytest.mark.parametrize("world,call", [("dp_sp_tp", 0), ("tp", 1)])
def test_sharded_inference_on_a_mesh_matches_tpuir(worlds, world, call):
    want = _tpuir_sharded_restormer()
    for rank in worlds[world]:
        got = rank[call]["serve"]["outputs"][0][0]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("axes,rank,want", [
    ({"dp": 1, "tp": 2}, 0, slice(0, 8)), ({"dp": 1, "tp": 2}, 1, slice(0, 8)),
    ({"dp": 2, "sp": 2, "tp": 2}, 3, slice(0, 4)), ({"dp": 2, "sp": 2, "tp": 2}, 4, slice(4, 8)),
    ({"dp": 3}, 2, slice(6, 9)),
])
def test_the_patch_grid_splits_over_dp_alone(axes, rank, want):
    """Ranks that differ only in sp or tp serve the same share of 8 patches."""
    n_pad, share = dp_share(Mesh(axes, rank), 8)
    assert share == want and n_pad == (-8) % axes["dp"]


@functools.lru_cache(maxsize=None)
def _dp_gathers():
    return launch(torch_mesh_jobs.dp_gathers, 4, args=({"dp": 2, "tp": 2},), device="cpu",
                  threads=1, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("route", ["host", "device"])
def test_patches_gather_over_dp_alone(route):
    """On a {dp: 2, tp: 2} world each rank gathers the shares of the ranks
    that share its tp coordinate, in dp order, and no other rank's."""
    for rank, got in enumerate(_dp_gathers()):
        want = np.array([[rank % 2], [2 + rank % 2]], np.float32)
        assert np.array_equal(got[route], want), (rank, got[route])


def test_every_axis_of_one_is_the_single_process_step():
    """The mesh step with dp, sp and tp all 1 is train_step, bit for bit."""
    from tpuir_torch.parallel.dist import destroy_dist, init_dist
    from tpuir_torch.train.archs import build_network, init_state_dict
    from tpuir_torch.train.losses import l1_loss
    from tpuir_torch.train.schedulers import build_scheduler
    from tpuir_torch.train.trainer import TrainState, build_optimizer, train_step

    init_dist(device="cpu")
    try:
        trains = _trains()[:1]
        got = dryrun.dryrun_multichip({"dp": 1, "sp": 1, "tp": 1}, trains)["train"][0]
    finally:
        destroy_dist()
    net_g, seed = NETWORKS["Restormer"]
    net = build_network(net_g)
    net.load_state_dict(init_state_dict(net_g, seed))
    state = TrainState(net, build_optimizer(dryrun.OPTIM, net.parameters()),
                       build_scheduler(dryrun.OPTIM["lr"], dryrun.SCHEDULE), dryrun.EMA_DECAY)
    lq, gt = _batches()
    for i in range(STEPS):
        log = train_step(state, torch.from_numpy(lq[i]).permute(0, 3, 1, 2).contiguous(),
                         torch.from_numpy(gt[i]).permute(0, 3, 1, 2).contiguous(), l1_loss,
                         dryrun.GRAD_CLIP)
        assert float(log["loss"]) == got["loss"][i]
        for k, p in net.named_parameters():
            assert np.array_equal(p.detach().numpy(), got["params"][i][k]), k
            assert np.array_equal(p.grad.numpy(), got["grads"][i][k]), k
            assert np.array_equal(state.ema[k].numpy(), got["ema"][i][k]), k
