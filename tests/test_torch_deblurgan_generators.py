"""The port's four extra DeblurGANv2 generators (ResNet, FPN-Inception-Simple,
FPN-Dense, UNet-SEResNeXt) against tpuir on the CPU.

A seeded torch-layout state dict goes through tpuir's ``convert_state_dict``
and jitted ``apply`` (eager takes four times as long) and through the
port's ``load_checkpoint``, on the same numpy-seeded input in [-1, 1]:

* float32 forward at full width: atol 1e-4. Each at the smallest input its
  path takes: FPN-Inception-Simple 160x160 (the Inception trunk's smallest
  practical input), FPN-Dense and UNet-SEResNeXt 96x96 (their deepest maps
  3x3; FPN-Dense at batch 2, its BatchNorms pooling the batch), the ResNet
  generator at 32x32 and a narrow one (two blocks, no residual) at batch 2;
* ``state_dict_from_jax`` against each converter, bit for bit;
* the builders put the network on the device asked for, and ``cuda``
  raises without a card;
* on a card (``cuda`` marker): one L1 step of each generator, card
  against CPU: the float32 output atol 1e-4, each gradient in float64
  within 1e-3 relative L2.

JAX is imported only on the reference side.
"""

import importlib

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

from tpuir_torch.models.deblurgan import norms as pnorms

ATOL = 1e-4
GRAD_RTOL = 1e-3

# name: (module, config, tpuir class, converter kwargs, input NHWC)
GENERATORS = {
    "resnet": ("resnet_gen", {}, "ResnetGenerator", {}, (1, 32, 32, 3)),
    "resnet-narrow": ("resnet_gen", dict(ngf=8, n_blocks=2, learn_residual=False),
                      "ResnetGenerator", dict(n_blocks=2), (2, 24, 20, 3)),
    "inception-simple": ("fpn_inception_simple", {}, "FPNInceptionSimple", {}, (1, 160, 160, 3)),
    "dense": ("fpn_densenet", {}, "FPNDense", {}, (2, 96, 96, 3)),
    "seresnext": ("unet_seresnext", {}, "UNetSEResNext", {}, (1, 96, 96, 3)),
}
CLASSES = {"resnet_gen": "ResnetGenerator", "fpn_inception_simple": "FPNInceptionSimple",
           "fpn_densenet": "FPNDense", "unet_seresnext": "UNetSEResNext"}


def _signed(shape, seed):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2).astype(np.float32)


def _port(name):
    modname, config, _, _, shape = GENERATORS[name]
    mod = importlib.import_module(f"tpuir_torch.models.deblurgan.{modname}")
    cls = getattr(mod, CLASSES[modname])
    sd = mod.init_state_dict(seed=3, **config)
    return mod, cls, config, sd, shape


@pytest.fixture(scope="module", params=sorted(GENERATORS))
def gen(request):
    mod, cls, config, sd, shape = _port(request.param)
    modname, _, jcls, conv_kw, _ = GENERATORS[request.param]
    jmod = importlib.import_module(f"tpuir.models.deblurgan.{modname}")
    jconfig = dict(config)
    params = jmod.convert_state_dict({f"module.{k}": v.numpy() for k, v in sd.items()},
                                     **conv_kw)
    return dict(name=request.param, mod=mod, sd=sd, jmod=jmod, conv_kw=conv_kw,
                net=pnorms.load_checkpoint(cls(**config), sd),
                jmodel=getattr(jmod, jcls)(**jconfig), params=params, x=_signed(shape, 4))


def test_forward_float32_matches_tpuir(gen):
    import jax

    want = np.asarray(jax.jit(gen["jmodel"].apply)(gen["params"], gen["x"]))
    with torch.no_grad():
        got = gen["net"](torch.from_numpy(gen["x"]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_state_dict_from_jax_inverts_the_converter(gen):
    from jax.tree_util import tree_leaves_with_path

    kw = {"n_blocks": gen["conv_kw"]["n_blocks"]} if "n_blocks" in gen["conv_kw"] else {}
    back = gen["mod"].state_dict_from_jax(gen["params"], **kw)
    assert back.keys() == gen["sd"].keys()
    initial = {"running_mean": 0, "running_var": 1, "num_batches_tracked": 0}
    for k, v in back.items():
        leaf = k.rsplit(".", 1)[-1]
        want = torch.full_like(v, initial[leaf]) if leaf in initial else gen["sd"][k]
        assert v.dtype == want.dtype and torch.equal(v, want), k
    again = dict(tree_leaves_with_path(gen["jmod"].convert_state_dict(
        {k: v.numpy() for k, v in back.items()}, **gen["conv_kw"])))
    leaves = tree_leaves_with_path(gen["params"])
    assert len(again) == len(leaves)
    for path, leaf in leaves:
        assert np.array_equal(np.asarray(again[path]), np.asarray(leaf)), path


@pytest.mark.parametrize("modname", sorted(CLASSES))
def test_builders_take_an_explicit_device(modname):
    mod = importlib.import_module(f"tpuir_torch.models.deblurgan.{modname}")
    kw = dict(ngf=4, n_blocks=1) if modname == "resnet_gen" else {}
    if modname == "resnet_gen":
        net = mod.build(device="cpu", seed=1, **kw)
        assert isinstance(net, mod.ResnetGenerator)
        assert all(p.device.type == "cpu" for p in net.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.build(**kw)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _l1_step(net, x, target):
    net.zero_grad(set_to_none=True)
    out = net(x)
    torch.mean(torch.abs(out - target)).backward()
    return out.detach().cpu(), {k: p.grad.detach().cpu() for k, p in net.named_parameters()}


def _rel_l2(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / max(float(torch.linalg.vector_norm(want.double())), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet", "inception-simple", "dense", "seresnext"])
def test_generator_step_on_card_matches_cpu(cuda_device, name):
    """One L1 step at full width: the float32 output within 1e-4 of the
    CPU's, every gradient in float64 within 1e-3 relative L2 of the CPU's
    (in float32 these deep normalized networks' gradients miss float64 by
    up to 1e-2 a tensor on the CPU as on the card:
    ``python -m tpuir_torch.utils.gan_precision``)."""
    from tpuir_torch.core.engine import true_float32

    mod, cls, config, sd, _ = _port(name)
    x = torch.from_numpy(_signed((1, 3, 128, 128), 5))
    target = torch.from_numpy(_signed((1, 3, 128, 128), 6))
    runs = {}
    for dtype in (torch.float32, torch.float64):
        for dev in (torch.device("cpu"), cuda_device):
            net = mod.build(sd, device=dev, **config).train().to(dtype)
            with true_float32():
                runs[dtype, dev.type] = _l1_step(net, x.to(dev, dtype), target.to(dev, dtype))
    np.testing.assert_allclose(runs[torch.float32, "cuda"][0].numpy(),
                               runs[torch.float32, "cpu"][0].numpy(), rtol=0, atol=ATOL)
    got, want = runs[torch.float64, "cuda"][1], runs[torch.float64, "cpu"][1]
    total = float(torch.sqrt(sum((w ** 2).sum() for w in want.values())))
    for k, w in want.items():
        if float(w.norm()) <= 1e-5 * total:  # a conv bias a norm follows: zero by construction
            assert float(got[k].norm()) <= 1e-5 * total, k
        else:
            assert _rel_l2(got[k], w) <= GRAD_RTOL, (k, _rel_l2(got[k], w))
