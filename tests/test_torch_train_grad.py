"""Gradients through the kernel wrappers (``ops/kernel_grad.py``) and through
the port's networks, against tpuir.

On the CPU: each of the five differentiable wrappers (K6, K2, K7, K5, K3,
parity bodies) goes through its ``torch.autograd.Function`` and gives the
gradients of direct autograd through its plain version bit for bit, and a
float64 ``gradcheck`` at the smallest shape; tiny MaIR-CDN (every NSS
route), MaIRUNet (stripe and sequence levels), Restormer and DnCNN give the
gradients of an L1 loss that tpuir's ``jax.grad`` gives on its CPU XLA path,
the port's gradients re-laid out by tpuir's own ``convert_state_dict``.

On a card (``cuda`` marker; ``python -m pytest --noconftest -m cuda``): the
kernel forward's gradients against the plain forward's at a tiny MaIR-CDN
and MaIRUNet on every route, no launch in a backward, the launches under
``torch.no_grad()`` as before, and the serving bodies (and K1, K4) still
raising under autograd.

JAX is imported inside the tests that need it, so the card tests run where
JAX is absent.
"""

import functools

import numpy as np
import pytest
import torch

from tpuir_torch.core.engine import true_float32
from tpuir_torch.ops import _kernels, kernel_grad
from tpuir_torch.ops import nss_epilogue, nss_fused, nss_prologue, nss_stripe, scan_fused_proj
from tests.torch_threads import one_torch_thread  # noqa: F401

# a gradient tensor of the port against tpuir's (or the kernel forward's
# against the plain forward's): |g - g_ref| <= GRAD_RTOL |g_ref| (L2 norms)
# + GRAD_ATOL sqrt(numel); float32 sums in another order, as the forward's
# tolerance (1e-4 atol, 1e-3 rtol, tests/test_mair.py:87)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _operands(kind, B=1, H=8, W=8, dm=6, di=6, n=4, r=2, seed=0):
    """Seeded float32 inputs of one wrapper (its tensor arguments, in order)
    and its static arguments."""
    rng = np.random.RandomState(seed)
    if kind == "prologue":
        ts = [_rand(rng, B, H, W, dm, scale=0.5), _rand(rng, 2 * di, dm, scale=dm ** -0.5),
              _rand(rng, di, 1, 3, 3, scale=0.3), _rand(rng, di, scale=0.05)]
        return ts, ()
    if kind == "epilogue":
        ts = [_rand(rng, B, 4, H, W, di), 1 / (1 + np.exp(-_rand(rng, B, 4, di))),
              _rand(rng, B, H, W, di), 1 + _rand(rng, di, scale=0.1),
              _rand(rng, di, scale=0.1), _rand(rng, dm, di, scale=di ** -0.5)]
        return [t.astype(np.float32) for t in ts], ()
    x = _rand(rng, B, 4, H * W, di) if kind == "sequence" else _rand(rng, B, H, W, di)
    w = [_rand(rng, 4, r + 2 * n, di, scale=di ** -0.5), _rand(rng, 4, di, r, scale=r ** -0.5),
         -np.exp(_rand(rng, 4, di, n, scale=0.3)), _rand(rng, 4, di, scale=0.3),
         _rand(rng, 4, di, scale=0.3)]
    return [x, *w], (() if kind == "sequence" else (4, kind == "fused"))


# wrapper, its plain version, its Function (the module's _parity_grad)
WRAPPERS = {
    "prologue": (nss_prologue.mixer_prologue, nss_prologue.mixer_prologue_plain,
                 nss_prologue._parity_grad),
    "stripe": (nss_stripe.nss_scan, nss_stripe.nss_scan_plain, nss_stripe._parity_grad),
    "epilogue": (nss_epilogue.mixer_epilogue, nss_epilogue.mixer_epilogue_plain,
                 nss_epilogue._parity_grad),
    "fused": (nss_fused.nss_scan_fused, nss_fused.nss_scan_fused_plain, nss_fused._parity_grad),
    "sequence": (scan_fused_proj.selective_scan_fused_proj,
                 scan_fused_proj.selective_scan_fused_proj_plain, scan_fused_proj._parity_grad),
}


def _grads(fn, tensors, static, seed=7):
    """Gradients of sum(out_i * cotangent_i) for seeded cotangents."""
    ts = [t.detach().clone().requires_grad_() for t in tensors]
    outs = fn(*ts, *static)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=ts[0].device).manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
    return outs, torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_function_equals_plain_autograd_on_cpu(kind):
    """The wrapper's call under autograd goes through the Function, and its
    gradients are direct autograd's through the plain version, bit for bit."""
    wrapper, plain, _ = WRAPPERS[kind]
    arrays, static = _operands(kind)
    tensors = [torch.from_numpy(a) for a in arrays]
    outs, got = _grads(wrapper, tensors, static)
    assert all(type(o.grad_fn).__name__ == "_KernelFunctionBackward" for o in outs)
    want_outs, want = _grads(plain, tensors, static)
    for o, w in zip(outs, want_outs):
        assert torch.equal(o, w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_function_gradcheck_float64(kind):
    """float64 gradcheck of the Function (plain forward on the CPU) at the
    smallest shape: its backward is the derivative of its forward."""
    _, _, fn = WRAPPERS[kind]
    arrays, static = _operands(kind, B=1, H=4, W=4, dm=3, di=2, n=2, r=1, seed=3)
    ts = tuple(torch.from_numpy(a).double().requires_grad_() for a in arrays)
    assert torch.autograd.gradcheck(lambda *t: fn(t, static), ts, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def test_function_saves_only_its_inputs_and_skips_unneeded_grads():
    """Only the weights need a gradient: x gets None, and the backward
    differentiates the plain version with respect to the weights alone."""
    arrays, static = _operands("stripe")
    x, *w = [torch.from_numpy(a) for a in arrays]
    w = [t.requires_grad_() for t in w]
    y, pooled = nss_stripe.nss_scan(x, *w, *static)
    assert len(y.grad_fn.saved_tensors) == 6
    grads = torch.autograd.grad(y.sum() + pooled.sum(), w)
    want = torch.autograd.grad(sum(o.sum() for o in nss_stripe.nss_scan_plain(x, *w, *static)),
                               w)
    assert all(torch.equal(g, v) for g, v in zip(grads, want))


def _assert_close(got, want, what=""):
    """The module's L2 bound on one gradient tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm(got - want)
    bound = GRAD_RTOL * np.linalg.norm(want) + GRAD_ATOL * np.sqrt(want.size)
    assert err <= bound, f"{what}: |d| {err:.3e} > {bound:.3e} (|ref| {np.linalg.norm(want):.3e})"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _port_grads(net, sd, x, target):
    """The port's L1-loss gradients by parameter name (NHWC x, target)."""
    net.load_state_dict(sd)
    net.train()
    with true_float32():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2))
        loss = (out - torch.from_numpy(target).permute(0, 3, 1, 2)).abs().mean()
        loss.backward()
    return {k: p.grad.numpy() for k, p in net.named_parameters()}


def _jax_grads(model, params, x, target):
    import jax
    import jax.numpy as jnp

    def loss_of(p):
        return jnp.mean(jnp.abs(model.apply(p, x) - target))

    return _leaves(jax.jit(jax.grad(loss_of))(params))


def _held_to_jax(port_grads, convert, jax_grads):
    """Re-lay the port's gradients out with tpuir's converter and hold each
    leaf to tpuir's."""
    mapped = _leaves(convert({k: v for k, v in port_grads.items()}))
    assert mapped.keys() == jax_grads.keys()
    for k in jax_grads:
        _assert_close(mapped[k], jax_grads[k], k)


MAIR_TINY = dict(embed_dim=16, depths=(1, 1), d_state=4, ssm_ratio=1.5, mlp_ratio=2.0,
                 scan_len=4)
UNET_TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, ssm_ratio=2.0,
                 flp_ratio=4.0, mlp_ratio=1.5, scan_len=4)


def _case(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mair_reference(h, w):
    """(x, target, sd, tpuir's gradients, converter) of the tiny MaIR-CDN."""
    from tpuir.models import mair as jm
    from tpuir_torch.models.mair import init_state_dict

    sd = init_state_dict(MAIR_TINY, seed=0)
    convert = functools.partial(jm.convert_state_dict, depths=MAIR_TINY["depths"],
                                embed_dim=MAIR_TINY["embed_dim"],
                                ssm_ratio=MAIR_TINY["ssm_ratio"])
    model = jm.MaIR(**MAIR_TINY, scan_chunk=64)
    x, target = _case((1, h, w, 3), seed=h + w)
    params = convert({k: v.numpy() for k, v in sd.items()})
    return x, target, sd, _jax_grads(model, params, x, target), convert


@pytest.mark.parametrize("nss", ["stripe", "fused", "0"])
def test_tiny_mair_grads_match_tpuir(monkeypatch, nss):
    """MaIR-CDN with ``fused=True`` on each NSS route (K6 -> K2 -> K7, K5,
    K3, all through their Functions on the CPU) against tpuir's jax.grad."""
    from tpuir_torch.models import mair as pm

    monkeypatch.delenv("TPUIR_FUSED_INTERPRET", raising=False)
    x, target, sd, want, convert = _mair_reference(16, 12)
    got = _port_grads(pm.MaIR(**MAIR_TINY, fused=True, nss=nss), sd, x, target)
    _held_to_jax(got, convert, want)


def test_tiny_mair_unet_grads_match_tpuir(monkeypatch):
    """MaIRUNet at 16x24: levels 16x24 and 8x12 on the stripe route, 4x6 and
    the 2x3 latent on the sequence route (K3)."""
    from tpuir.models import mair_unet as ju
    from tpuir_torch.models import mair_unet as pu

    monkeypatch.delenv("TPUIR_FUSED_INTERPRET", raising=False)
    sd = pu.init_state_dict(UNET_TINY, seed=0)
    cfg = dict(UNET_TINY)
    cfg["use_bias"] = cfg.pop("bias", False)
    convert = functools.partial(ju.convert_state_dict, dim=cfg["dim"],
                                num_blocks=cfg["num_blocks"],
                                num_refinement_blocks=cfg["num_refinement_blocks"],
                                ssm_ratio=cfg["ssm_ratio"])
    x, target = _case((1, 16, 24, 3), seed=5)
    want = _jax_grads(ju.MaIRUNet(**cfg, scan_chunk=64),
                      convert({k: v.numpy() for k, v in sd.items()}), x, target)
    got = _port_grads(pu.MaIRUNet(**UNET_TINY, fused=True), sd, x, target)
    _held_to_jax(got, convert, want)


def test_tiny_restormer_grads_match_tpuir():
    """The plain Restormer (as training builds it) against tpuir's."""
    from tpuir.models import restormer as jres
    from tpuir_torch.models.restormer import Restormer, init_state_dict

    config = dict(inp_channels=3, out_channels=3, dim=8, num_blocks=(1, 1, 1, 1),
                  num_refinement_blocks=1, heads=(1, 2, 4, 8), ffn_expansion_factor=2.66,
                  bias=False, layer_norm_bias=False, dual_pixel_task=False)
    sd = init_state_dict(config, seed=0)
    convert = lambda s: jres.convert_state_dict(s, (1, 1, 1, 1), 1, False, False, False)  # noqa: E731
    model = jres.Restormer(inp_channels=3, out_channels=3, dim=8, num_blocks=(1, 1, 1, 1),
                           num_refinement_blocks=1, heads=(1, 2, 4, 8), layer_norm_bias=False)
    x, target = _case((1, 16, 16, 3), seed=2)
    want = _jax_grads(model, convert({k: v.numpy() for k, v in sd.items()}), x, target)
    got = _port_grads(Restormer(**config, fused=False), sd, x, target)
    _held_to_jax(got, convert, want)


def test_tiny_dncnn_grads_match_tpuir():
    from tpuir.models import dncnn as jd
    from tpuir_torch.models.dncnn import DnCNN, init_state_dict

    sd = init_state_dict(1, nb=4, seed=0)
    convert = lambda s: jd.convert_state_dict(s, 4)  # noqa: E731
    x, target = _case((1, 16, 16, 1), seed=3)
    want = _jax_grads(jd.DnCNN(in_nc=1, out_nc=1, nc=64, nb=4),
                      convert({k: v.numpy() for k, v in sd.items()}), x, target)
    got = _port_grads(DnCNN(1, 1, 64, 4), sd, x, target)
    _held_to_jax(got, convert, want)


# -- on the card ---------------------------------------------------------


def _net_grads(net, x):
    """Gradients of a seeded cotangent of net(x), by parameter name, and the
    launches made in the forward and in the backward."""
    net.zero_grad(set_to_none=True)
    _kernels.reset_launches()
    with true_float32():
        out = net(x)
        fwd = dict(_kernels.LAUNCHES)
        _kernels.reset_launches()
        g = torch.Generator(device=x.device).manual_seed(1)
        (out * torch.randn(out.shape, generator=g, device=x.device)).sum().backward()
    bwd = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    return {k: p.grad.double().cpu().numpy() for k, p in net.named_parameters()}, fwd, bwd


# model, config, input side, route -> the kernels the forward launches
CARD_CASES = {
    "mair-stripe": ("mair", MAIR_TINY, (16, 12), "stripe",
                    ("mixer_prologue", "nss_scan", "mixer_epilogue")),
    "mair-fused": ("mair", MAIR_TINY, (16, 12), "fused", ("nss_scan_fused",)),
    "mair-sequence": ("mair", MAIR_TINY, (16, 12), "0", ("selective_scan_fused_proj",)),
    "unet": ("unet", UNET_TINY, (16, 24), "stripe",
             ("mixer_prologue", "nss_scan", "mixer_epilogue", "selective_scan_fused_proj")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_forward_grads_match_plain_forward_on_card(cuda_device, case):
    """The Functions with the kernel forward give the plain forward's
    gradients within the module's bound; the forward launches each of the
    route's kernels and the backward launches none."""
    from tpuir_torch.models import mair, mair_unet

    kind, config, (h, w), nss, kernels = CARD_CASES[case]
    mod = mair if kind == "mair" else mair_unet
    net = (mod.MaIR(**config, fused=True, nss=nss) if kind == "mair"
           else mod.MaIRUNet(**config, fused=True))
    net.load_state_dict(mod.init_state_dict(config, seed=0))
    net = net.to(cuda_device).train()
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 3, h, w).astype(np.float32))
    x = x.to(cuda_device)
    got, fwd, bwd = _net_grads(net, x)
    assert all(fwd[k] > 0 for k in kernels), fwd
    assert not bwd, bwd
    with kernel_grad.plain_forwards():
        want, fwd_plain, _ = _net_grads(net, x)
    assert not any(fwd_plain.values()), fwd_plain
    for k in want:
        _assert_close(got[k], want[k], k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_function_on_card_matches_plain_autograd(cuda_device, kind):
    """Each wrapper at a small shape on the card: one launch in the forward,
    none in the backward, gradients within the bound of the plain version's
    direct autograd."""
    wrapper, plain, _ = WRAPPERS[kind]
    arrays, static = _operands(kind, B=2, H=16, W=16, dm=12, di=10, n=8, r=2, seed=1)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    with true_float32():
        _kernels.reset_launches()
        _, got = _grads(wrapper, tensors, static)
        assert sum(_kernels.LAUNCHES.values()) == 1, _kernels.LAUNCHES
        _kernels.reset_launches()
        _, want = _grads(plain, tensors, static)
        assert sum(_kernels.LAUNCHES.values()) == 0
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g.cpu(), w.cpu(), f"{kind} input {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_no_grad_launches_as_before_on_card(cuda_device, kind):
    """Under torch.no_grad() the wrapper launches its kernel once and
    returns what its launch returns, with no autograd record."""
    wrapper, _, _ = WRAPPERS[kind]
    arrays, static = _operands(kind, B=2, H=16, W=16, dm=12, di=10, n=8, r=2, seed=2)
    tensors = [torch.from_numpy(a).to(cuda_device).requires_grad_() for a in arrays]
    _kernels.reset_launches()
    with torch.no_grad():
        outs = wrapper(*tensors, *static)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert sum(_kernels.LAUNCHES.values()) == 1
    assert all(o.grad_fn is None for o in outs)


@pytest.mark.cuda
def test_serving_bodies_k1_and_k4_raise_under_autograd_on_card(cuda_device):
    """Serving has no gradient (tpuir trains in float32), K1 is not trained
    (tpuir trains the plain Restormer) and K4 has no backward rule in tpuir."""
    from tpuir_torch.ops.selective_scan import selective_scan_kernel

    dev = cuda_device
    arrays, _ = _operands("prologue", B=1, H=8, W=8, dm=16, di=16, seed=0)
    h, *w = [torch.from_numpy(a).to(dev) for a in arrays]
    with pytest.raises(RuntimeError, match="no backward"):
        nss_prologue.mixer_prologue(h, *[t.requires_grad_() for t in w], serving=True)
    arrays, static = _operands("stripe", B=1, H=8, W=8, di=16, n=8, r=2, seed=0)
    x, *w = [torch.from_numpy(a).to(dev) for a in arrays]
    xb = x.to(torch.bfloat16)
    for fn in (nss_stripe.nss_scan, nss_fused.nss_scan_fused):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(xb, *[t.requires_grad_() for t in w], *static, serving=True)
    xs = x.reshape(1, 4, 16, 16).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        scan_fused_proj.selective_scan_fused_proj(xs, *w, serving=True)
    arrays, _ = _operands("epilogue", B=1, H=8, W=8, dm=16, di=16, seed=0)
    y, gates, z, *ew = [torch.from_numpy(a).to(dev) for a in arrays]
    with pytest.raises(RuntimeError, match="no backward"):
        nss_epilogue.mixer_epilogue(y.to(torch.bfloat16), gates, z.to(torch.bfloat16),
                                    *[t.requires_grad_() for t in ew], serving=True)
    u = torch.randn(1, 4, 64, 16, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        selective_scan_kernel(u, torch.randn(1, 4, 64, 16, device=dev), w[2],
                              torch.randn(1, 4, 64, 8, device=dev),
                              torch.randn(1, 4, 64, 8, device=dev), w[3], w[4])
    from tpuir_torch.models.restormer import Restormer

    net = Restormer(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                    heads=(1, 2, 4, 8), fused=True).to(dev)
    with pytest.raises(RuntimeError, match="no backward"):
        net(torch.rand(1, 3, 16, 16, device=dev))


@pytest.mark.parametrize("nss", ["fused", "0"])
def test_training_after_serving_under_inference_mode(nss):
    """A shape first served under ``torch.inference_mode()`` (as the engine
    serves) and then trained: the cached index tensors of the fused and
    sequence routes are ones autograd can save."""
    from tpuir_torch.models import mair as pm
    from tpuir_torch.ops import scan_ids

    scan_ids._DEVICE_IDS.clear()
    net = pm.MaIR(**MAIR_TINY, fused=True, nss=nss)
    net.load_state_dict(pm.init_state_dict(MAIR_TINY, seed=0))
    x = torch.rand(1, 3, 20, 12)
    with torch.inference_mode():
        want = net(x)
    out = net(x)
    out.sum().backward()
    assert torch.equal(out.detach(), want)
    assert all(p.grad is not None for p in net.parameters())
