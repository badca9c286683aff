"""DeblurGANv2 training on the port against tpuir on the CPU: discriminators,
the VGG19 trunk, every loss of ``get_loss`` and its gradients, ImagePool,
and the G/D alternation.

The same numpy-seeded inputs and torch-layout state dicts go to both sides
(tpuir's converters on one, the port's modules on the other):

* discriminators (PatchGAN with 3 and 5 layers, instance and batch norm;
  multi-scale; ``get_discriminator``): atol 1e-4; ``state_dict_from_jax``
  bit for bit;
* the VGG19 conv3_3 trunk: atol 1e-4, its key forms, ``state_dict_from_jax``;
* every loss of ``get_loss`` on the same discriminator weights within 1e-5
  relative: WGAN-GP with an explicit alpha, the relativistic losses from
  seeded pools and with explicit means; the perceptual loss at batch 2
  (only batch element 0 is ImageNet-normalized, which batch 1 cannot
  show);
* the gradients of each loss with respect to D's weights and to G's
  output, and of WGAN-GP's penalty alone (a double backward), against
  ``jax.grad``: relative L2 <= 1e-4 a tensor; a tensor that is zero by
  construction (a conv bias that an instance norm follows) must be
  rounding noise on both sides instead (``_assert_grads``);
* ImagePool's ``random.sample`` draws under one ``random`` seed;
* four G/D steps of ``tests/test_deblurgan_train_step.py``'s loop (tiny
  ResnetGenerator, double_gan, wgan-gp, L1, adv_lambda 0.001, Adam 1e-3):
  each step starts from the reference's weights (G, both Ds, and the
  optimizers fed the reference's gradients), losses 1e-5 relative,
  gradients 1e-4 relative L2, the Adam updates within 1e-6 of optax's;
* on a card (``cuda`` marker): WGAN-GP's D loss on the card against the
  CPU, 1e-4 relative in float32, and its gradients in float64 (1e-3
  relative L2 a tensor): float32 gradients of the double backward differ
  by more than that between any two implementations.

JAX is imported only on the reference side.
"""

import random

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

from tpuir_torch.models.deblurgan import discriminators as pd
from tpuir_torch.models.deblurgan import resnet_gen as prg
from tpuir_torch.models.deblurgan.norms import load_checkpoint
from tpuir_torch.train import deblurgan_losses as pl
from tpuir_torch.train import vgg_features as pv
from tpuir_torch.utils.misc import seeded_state_dict

ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_SHARE = 1e-5  # a gradient tensor this small a share of the whole is zero by construction
CARD_LOSS_RTOL, CARD_GRAD_RTOL = 1e-4, 1e-3


def _signed(shape, seed):
    return ((np.random.RandomState(seed).rand(*shape) - 0.5) * 2).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _seeded(net, seed):
    """``net`` with seeded weights (biases and norm affines included)."""
    net.load_state_dict(seeded_state_dict(net, seed))
    return net


DISCS = {  # name: (port factory, tpuir factory name + kwargs, converter, input NHWC)
    "patch3-instance": (lambda: pd.NLayerDiscriminator(n_layers=3, norm="instance"),
                        ("NLayerDiscriminator", dict(n_layers=3, norm="instance")),
                        dict(n_layers=3, norm="instance"), (2, 32, 32, 3)),
    "patch5-instance": (lambda: pd.NLayerDiscriminator(n_layers=5, norm="instance"),
                        ("NLayerDiscriminator", dict(n_layers=5, norm="instance")),
                        dict(n_layers=5, norm="instance"), (1, 32, 32, 3)),
    "patch3-batch": (lambda: pd.NLayerDiscriminator(n_layers=3, norm="batch"),
                     ("NLayerDiscriminator", dict(n_layers=3, norm="batch")),
                     dict(n_layers=3, norm="batch"), (2, 32, 32, 3)),
    "patch5-batch": (lambda: pd.NLayerDiscriminator(n_layers=5, norm="batch"),
                     ("NLayerDiscriminator", dict(n_layers=5, norm="batch")),
                     dict(n_layers=5, norm="batch"), (2, 32, 32, 3)),
    "multi-scale": (lambda: pd.MultiScaleDiscriminator(norm="instance"),
                    ("MultiScaleDiscriminator", dict(norm="instance")), None, (2, 64, 64, 3)),
}


def _jax_disc(name, net):
    """tpuir's discriminator and params for the port's ``net``."""
    from tpuir.models.deblurgan import discriminators as jd

    _, (cls, kw), conv_kw, _ = DISCS[name]
    sd = {f"module.{k}": v.numpy() for k, v in net.state_dict().items()}
    params = (jd.convert_nlayer(sd, **conv_kw) if conv_kw is not None
              else jd.convert_multiscale(sd, norm="instance"))
    return getattr(jd, cls)(**kw), params


@pytest.fixture(scope="module", params=sorted(DISCS))
def disc(request):
    factory, _, _, shape = DISCS[request.param]
    net = _seeded(factory(), 11)
    jmod, params = _jax_disc(request.param, net)
    return dict(name=request.param, net=net, jmod=jmod, params=params, x=_signed(shape, 12))


def test_discriminator_forward_matches_tpuir(disc):
    import jax

    want = jax.jit(disc["jmod"].apply)(disc["params"], disc["x"])
    with torch.no_grad():
        got = disc["net"](_nchw(disc["x"]))
    if not isinstance(got, list):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _nhwc(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0, atol=ATOL)


def test_discriminator_state_dict_from_jax(disc):
    back = pd.state_dict_from_jax(disc["params"], disc["net"])
    own = disc["net"].state_dict()
    assert back.keys() == own.keys()
    initial = {"running_mean": 0, "running_var": 1, "num_batches_tracked": 0}
    for k, v in back.items():
        leaf = k.rsplit(".", 1)[-1]
        want = torch.full_like(v, initial[leaf]) if leaf in initial else own[k]
        assert v.dtype == want.dtype and torch.equal(v, want), k


def test_batch_norm_train_pools_the_batch_and_ignores_running_stats():
    from tpuir.models.deblurgan.discriminators import _BatchNormTrain

    x = _signed((3, 5, 4, 6), 1) * 2 + 0.3
    bn = pd.BatchNormTrain(6)
    rng = np.random.RandomState(2)
    w, b = (1 + 0.1 * rng.randn(6)).astype(np.float32), (0.1 * rng.randn(6)).astype(np.float32)
    bn.weight.data, bn.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    bn.running_mean.normal_()
    before = bn.running_mean.clone()
    want = np.asarray(_BatchNormTrain(6).apply({"params": {"weight": w, "bias": b}}, x))
    got = _nhwc(bn.eval()(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert torch.equal(bn.running_mean, before)


def test_get_discriminator_matches_tpuir():
    from tpuir.models.deblurgan import discriminators as jd

    for cfg in ({"d_name": "double_gan", "d_layers": 3, "norm_layer": "instance"},
                {"d_name": "patch_gan", "d_layers": 4, "norm_layer": "batch"},
                {"d_name": "multi_scale", "norm_layer": "instance"}, {"d_name": "no_gan"}):
        got, want = pd.get_discriminator(cfg, device="cpu"), jd.get_discriminator(cfg)
        assert set(got) == set(want)
        for k, net in got.items():
            assert type(net).__name__ == type(want[k]).__name__
            assert all(p.device.type == "cpu" for p in net.parameters())
            if isinstance(net, pd.NLayerDiscriminator):
                assert (net.n_layers, net.norm) == (want[k].n_layers, want[k].norm)
    with pytest.raises(ValueError):
        pd.get_discriminator({"d_name": "bogus"}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pd.get_discriminator({"d_name": "patch_gan", "d_layers": 3})


# -- the VGG19 trunk -----------------------------------------------------------


@pytest.fixture(scope="module")
def vgg():
    from tpuir.train.vgg_features import convert_vgg19_features

    sd = pv.init_state_dict(seed=21)
    net = pv.load_vgg19_features(pv.VGG19Conv33(), sd)
    return dict(sd=sd, net=net, params=convert_vgg19_features({k: v.numpy() for k, v in sd.items()}))


def test_vgg_trunk_matches_tpuir(vgg):
    from tpuir.train.vgg_features import VGG19Conv33

    x = _signed((2, 20, 28, 3), 22)
    want = np.asarray(VGG19Conv33().apply(vgg["params"], x))
    with torch.no_grad():
        got = _nhwc(vgg["net"](_nchw(x)))
    assert got.shape == want.shape == (2, 5, 7, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_vgg_keys_and_state_dict_from_jax(vgg):
    back = pv.state_dict_from_jax(vgg["params"])
    assert back.keys() == vgg["sd"].keys()
    assert all(torch.equal(back[k], vgg["sd"][k]) for k in back)
    # a torchvision checkpoint (classifier and later layers ignored) and the
    # original's sliced Sequential (bare indices) load the same weights
    full = dict(vgg["sd"], **{"features.16.weight": torch.zeros(256, 256, 3, 3),
                              "classifier.0.weight": torch.zeros(4, 4)})
    bare = {k[len("features."):]: v for k, v in vgg["sd"].items()}
    for sd in (full, bare):
        net = pv.load_vgg19_features(pv.VGG19Conv33(), sd)
        assert all(torch.equal(v, vgg["sd"][k]) for k, v in net.state_dict().items())


# -- losses --------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """A PatchGAN (3 layers, instance norm) on both sides and a batch of 2
    fake/real images, 32x32."""
    net = _seeded(pd.NLayerDiscriminator(n_layers=3), 31)
    jmod, params = _jax_disc("patch3-instance", net)
    fake, real = _signed((2, 32, 32, 3), 32), _signed((2, 32, 32, 3), 33)
    return dict(net=net, jmod=jmod, params=params, fake=fake, real=real)


def _jax_loss(pair, jloss, method, alpha=None, **kw):
    """tpuir's loss, its gradient with respect to D's params (as the port's
    state dict) and to the fake image."""
    import jax
    import jax.numpy as jnp

    def fn(params, fake):
        d_apply = pair["jmod"].apply
        if alpha is not None and method == "get_loss":
            wass = jnp.mean(d_apply(params, jax.lax.stop_gradient(fake))) - jnp.mean(
                d_apply(params, pair["real"]))
            return wass + jloss.calc_gradient_penalty(d_apply, params, pair["real"],
                                                     jax.lax.stop_gradient(fake), None,
                                                     alpha=alpha)
        return getattr(jloss, method)(d_apply, params, fake, pair["real"], **kw)

    val, (g_params, g_fake) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
        pair["params"], jnp.asarray(pair["fake"]))
    return float(val), pd.state_dict_from_jax(g_params, pair["net"]), np.asarray(g_fake)


def _port_loss(pair, loss, method, **kw):
    net = pair["net"]
    net.zero_grad(set_to_none=True)
    fake = _nchw(pair["fake"]).requires_grad_(True)
    val = getattr(loss, method)(net, fake, _nchw(pair["real"]), **kw)
    val.backward()
    grads = _grads(net)
    g_fake = np.zeros_like(pair["fake"]) if fake.grad is None else _nhwc(fake.grad)
    return float(val.detach()), grads, g_fake


def _grads(net):
    """{name: gradient} of ``net``'s parameters, zeros where none flowed."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in net.named_parameters()}


def _assert_grads(got, want, rtol=GRAD_RTOL):
    """Each gradient tensor within ``rtol`` relative L2 of the reference's,
    but for the ones that are zero by construction (the bias of a conv that
    an instance norm follows: the norm takes the mean out), which both
    sides must give as rounding noise: an L2 norm below ZERO_SHARE of the
    whole gradient's."""
    total = np.sqrt(sum(np.sum(np.asarray(w, np.float64) ** 2) for w in want.values()))
    assert got.keys() == want.keys()
    for k, g in got.items():
        w = np.asarray(want[k], np.float64)
        if np.linalg.norm(w) <= ZERO_SHARE * total:
            assert np.linalg.norm(np.asarray(g, np.float64)) <= ZERO_SHARE * total, k
        else:
            assert _rel_l2(g, w) <= rtol, (k, _rel_l2(g, w))


def _check(got, want):
    val, grads, g_fake = got
    wval, wgrads, wg_fake = want
    np.testing.assert_allclose(val, wval, rtol=LOSS_RTOL, atol=0)
    _assert_grads(grads, {k: wgrads[k] for k in grads})
    if np.any(wg_fake):
        assert _rel_l2(g_fake, wg_fake) <= GRAD_RTOL, _rel_l2(g_fake, wg_fake)
    else:
        assert not np.any(g_fake)


ADVERSARIAL = ["gan", "lsgan", "wgan-gp"]


@pytest.mark.parametrize("method", ["get_loss", "get_g_loss"])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_adversarial_losses_and_gradients_match_jax(pair, name, method):
    from tpuir.train import deblurgan_losses as jl

    cfg = {"content_loss": "l1", "disc_loss": name}
    _, loss = pl.get_loss(cfg, device="cpu")
    _, jloss = jl.get_loss(cfg)
    assert type(loss).__name__ == type(jloss).__name__
    kw, jkw = {}, {}
    if name == "wgan-gp" and method == "get_loss":
        kw, jkw = {"alpha": 0.37}, {"alpha": 0.37}
    _check(_port_loss(pair, loss, method, **kw), _jax_loss(pair, jloss, method, **jkw))


def test_gradient_penalty_alone_matches_jax_double_grad(pair):
    """The penalty's gradient with respect to D's weights: a gradient of a
    gradient on both sides."""
    import jax

    from tpuir.train import deblurgan_losses as jl

    alpha = np.float32(0.61)

    def jfn(params):
        return jl.DiscLossWGANGP().calc_gradient_penalty(
            pair["jmod"].apply, params, pair["real"], pair["fake"], None, alpha=alpha)

    wval, wg = jax.jit(jax.value_and_grad(jfn))(pair["params"])
    want = pd.state_dict_from_jax(wg, pair["net"])
    net = pair["net"]
    net.zero_grad(set_to_none=True)
    val = pl.DiscLossWGANGP().calc_gradient_penalty(net, _nchw(pair["real"]),
                                                    _nchw(pair["fake"]), alpha=float(alpha))
    val.backward()
    np.testing.assert_allclose(float(val), float(wval), rtol=LOSS_RTOL, atol=0)
    _assert_grads(_grads(net), _torch_like(want, net))


def test_gradient_penalty_alpha_from_a_generator():
    """alpha: one draw a call from the given generator; with none, the first
    draw of a generator seeded 0 (tpuir draws from PRNGKey(0) then)."""
    a = pl.DiscLossWGANGP.draw_alpha(torch.Generator().manual_seed(5))
    assert a.shape == (1, 1, 1, 1) and torch.equal(
        a, torch.rand((1, 1, 1, 1), generator=torch.Generator().manual_seed(5)))
    assert torch.equal(pl.DiscLossWGANGP.draw_alpha(), pl.DiscLossWGANGP.draw_alpha())
    net = _seeded(pd.NLayerDiscriminator(n_layers=3), 3)
    real, fake = _nchw(_signed((1, 32, 32, 3), 1)), _nchw(_signed((1, 32, 32, 3), 2))
    loss = pl.DiscLossWGANGP()
    by_gen = loss.calc_gradient_penalty(net, real, fake, torch.Generator().manual_seed(5))
    by_alpha = loss.calc_gradient_penalty(net, real, fake, alpha=a)
    assert torch.equal(by_gen, by_alpha)


POOLED = ["ragan", "ragan-ls"]


def _seed_pools(loss, jloss, shape, seed):
    """The same three seeded predictions in the fake and real pools of both."""
    for i, (p, jp) in enumerate(((loss.fake_pool, jloss.fake_pool),
                                 (loss.real_pool, jloss.real_pool))):
        preds = _signed((3,) + shape, seed + i)
        jp.add(preds)
        p.add(_nchw(preds))


@pytest.mark.parametrize("method", ["get_loss", "get_g_loss"])
@pytest.mark.parametrize("name", POOLED)
def test_relativistic_losses_from_seeded_pools(pair, name, method):
    """Without explicit means: ``get_loss`` adds D's predictions to both
    pools, then reads their means; ``get_g_loss`` reads them."""
    from tpuir.train import deblurgan_losses as jl

    cfg = {"content_loss": "l1", "disc_loss": name}
    _, loss = pl.get_loss(cfg, device="cpu")
    _, jloss = jl.get_loss(cfg)
    assert type(loss).__name__ == type(jloss).__name__
    _seed_pools(loss, jloss, (7, 7, 1), 40)  # D's output on 32x32
    got = _port_loss(pair, loss, method)
    means = {}
    if method == "get_loss":  # tpuir updates its pools on the host, eagerly
        jloss.update_pools(pair["jmod"].apply, pair["params"], pair["fake"], pair["real"])
        means = dict(zip(("fake_mean", "real_mean"), jloss.pool_means()))
    _check(got, _jax_loss(pair, jloss, method, **means))
    for p, jp in ((loss.fake_pool, jloss.fake_pool), (loss.real_pool, jloss.real_pool)):
        assert len(p.images) == len(jp.images)
        np.testing.assert_allclose(_nhwc(p.query()), jp.query(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("method", ["get_loss", "get_g_loss"])
@pytest.mark.parametrize("name", POOLED)
def test_relativistic_losses_with_explicit_means(pair, name, method):
    from tpuir.train import deblurgan_losses as jl

    cfg = {"content_loss": "l1", "disc_loss": name}
    _, loss = pl.get_loss(cfg, device="cpu")
    _, jloss = jl.get_loss(cfg)
    means = dict(fake_mean=np.float32(-0.23), real_mean=np.float32(0.41))
    got = _port_loss(pair, loss, method, **{k: torch.tensor(v) for k, v in means.items()})
    _check(got, _jax_loss(pair, jloss, method, **means))
    assert not loss.fake_pool.images and not jloss.fake_pool.images  # no pool update


def test_image_pool_draws_match_tpuir():
    from tpuir.train import deblurgan_losses as jl

    pool, jpool = pl.ImagePool(6), jl.ImagePool(6)
    pool.sample_size = jpool.sample_size = 3  # sample below the pool size
    for seed in range(3):
        batch = _signed((2, 4, 4, 1), seed)
        pool.add(_nchw(batch))
        jpool.add(batch)
    random.seed(7)
    got = [_nhwc(pool.query()) for _ in range(4)]
    random.seed(7)
    want = [jpool.query() for _ in range(4)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    pool.add(_nchw(_signed((2, 4, 4, 1), 9)))  # the oldest two go
    assert len(pool.images) == 6
    assert np.array_equal(_nhwc(pool.images[0]), _signed((2, 4, 4, 1), 1)[:1])


def test_content_and_perceptual_losses_at_batch_2(vgg):
    """The perceptual loss normalizes batch element 0 only: batch 2 shows it."""
    import jax

    from tpuir.train import deblurgan_losses as jl

    fake, real = _signed((2, 24, 24, 3), 50), _signed((2, 24, 24, 3), 51)
    content, _ = pl.get_loss({"content_loss": "perceptual", "disc_loss": "gan"},
                             vgg_state_dict=vgg["sd"], device="cpu")
    jcontent, _ = jl.get_loss({"content_loss": "perceptual", "disc_loss": "gan"},
                              vgg_params=vgg["params"])
    wval, wg = jax.jit(jax.value_and_grad(lambda f: jcontent(f, real)))(fake)
    tf = _nchw(fake).requires_grad_(True)
    val = content(tf, _nchw(real))
    val.backward()
    np.testing.assert_allclose(float(val), float(wval), rtol=LOSS_RTOL, atol=0)
    assert _rel_l2(_nhwc(tf.grad), wg) <= GRAD_RTOL
    # element 1 is not normalized: the loss is not that of the batch's
    # elements taken one at a time
    singles = [float(content(_nchw(fake[i:i + 1]), _nchw(real[i:i + 1]))) for i in range(2)]
    assert abs(float(val) - np.mean(singles)) > 1e-4 * abs(float(val))

    l1, _ = pl.get_loss({"content_loss": "l1", "disc_loss": "gan"}, device="cpu")
    jl1, _ = jl.get_loss({"content_loss": "l1", "disc_loss": "gan"})
    np.testing.assert_allclose(float(l1(_nchw(fake), _nchw(real))), float(jl1(fake, real)),
                               rtol=LOSS_RTOL, atol=0)
    for bad in ({"content_loss": "bogus", "disc_loss": "gan"},
                {"content_loss": "l1", "disc_loss": "bogus"},
                {"content_loss": "perceptual", "disc_loss": "gan"}):
        with pytest.raises(ValueError):
            pl.get_loss(bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pl.get_loss({"content_loss": "perceptual", "disc_loss": "gan"},
                        vgg_state_dict=vgg["sd"])


# -- the G/D alternation -------------------------------------------------------


def _torch_like(sd_back, net):
    """A state dict from ``state_dict_from_jax`` restricted to ``net``'s parameters."""
    names = dict(net.named_parameters())
    return {k: v for k, v in sd_back.items() if k in names}


def test_train_steps_follow_the_reference_loop():
    """tests/test_deblurgan_train_step.py's loop, the reference's weights at
    each step's start (PERF.md's rule for twins: Adam's first moves are
    lr*sign(g), so runs apart would part where g is near 0)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpuir.models.deblurgan import discriminators as jd
    from tpuir.models.deblurgan.resnet_gen import ResnetGenerator
    from tpuir.models.deblurgan.resnet_gen import convert_state_dict as convert_generator
    from tpuir.train import deblurgan_losses as jl
    from tpuir_torch.train.trainer import build_optimizer

    cfg = {"d_name": "double_gan", "d_layers": 3, "norm_layer": "instance",
           "content_loss": "l1", "disc_loss": "wgan-gp", "adv_lambda": 0.001}
    gen = ResnetGenerator(ngf=8, n_blocks=1)
    discs = jd.get_discriminator(cfg)
    content, disc_loss = jl.get_loss(cfg)
    rng = jax.random.PRNGKey(0)
    x = jax.random.uniform(rng, (1, 32, 32, 3), jnp.float32) * 2 - 1
    y = jnp.clip(x + 0.1, -1, 1)
    # seeded torch-layout weights through tpuir's converters (flax's init
    # of the three would take 20 s of op-by-op compiles), copied: the
    # converters keep a bias as the array they were given
    gp = convert_generator({k: v.numpy() for k, v in prg.init_state_dict(1, ngf=8, n_blocks=1)
                            .items()}, n_blocks=1)
    p_discs = pd.get_discriminator(cfg, device="cpu")
    dps = {k: jd.convert_nlayer({n: v.numpy().copy() for n, v in _seeded(p_discs[k], 2 + i)
                                 .state_dict().items()}, n_layers=p_discs[k].n_layers)
           for i, k in enumerate(("patch", "full"))}
    g_opt, d_opt = optax.adam(1e-3), optax.adam(1e-3)
    g_state, d_state = g_opt.init(gp), d_opt.init(dps)

    def accurate_jit(fn, *args):
        """``fn`` compiled without LLVM's optimizations: XLA's default
        contracts and reorders float32 arithmetic, which moves the full
        discriminator's penalty gradient by 4e-4 relative here, while the
        eager reference and this build stay within 1e-5 of float64."""
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})

    def d_grads(dps, gp, alpha):
        fake = gen.apply(gp, x)

        def loss_fn(dps):
            return 0.5 * sum(
                jnp.mean(discs[k].apply(dps[k], fake)) - jnp.mean(discs[k].apply(dps[k], y))
                + disc_loss.calc_gradient_penalty(discs[k].apply, dps[k], y, fake, None,
                                                  alpha=alpha)
                for k in ("patch", "full"))

        return jax.value_and_grad(loss_fn)(dps)

    def g_grads(gp, dps):
        def loss_fn(gp):
            fake = gen.apply(gp, x)
            adv = 0.5 * sum(disc_loss.get_g_loss(discs[k].apply, dps[k], fake, y)
                            for k in ("patch", "full"))
            return content(fake, y) + cfg["adv_lambda"] * adv

        return jax.value_and_grad(loss_fn)(gp)

    alpha0 = jax.random.uniform(rng, (1, 1, 1, 1))
    d_grads, g_grads = accurate_jit(d_grads, dps, gp, alpha0), accurate_jit(g_grads, gp, dps)
    p_gen = prg.ResnetGenerator(ngf=8, n_blocks=1)
    p_content, p_disc_loss = pl.get_loss(cfg, device="cpu")
    d_params = [p for k in ("patch", "full") for p in p_discs[k].parameters()]
    p_dopt = build_optimizer({"type": "Adam", "lr": 1e-3}, d_params)
    p_gopt = build_optimizer({"type": "Adam", "lr": 1e-3}, list(p_gen.parameters()))
    tx, ty = _nchw(np.asarray(x)), _nchw(np.asarray(y))

    def load_all(gp, dps):
        load_checkpoint(p_gen, prg.state_dict_from_jax(gp, n_blocks=1))
        for k in ("patch", "full"):
            p_discs[k].load_state_dict(pd.state_dict_from_jax(dps[k], p_discs[k]))

    def check_grads(net, got, want_params):
        _assert_grads(got, _torch_like(want_params, net))

    def feed(opt, nets_and_grads):
        for net, grads in nets_and_grads:
            for k, p in net.named_parameters():
                p.grad = grads[k].clone()
        opt.step()

    g_losses = []
    for step in range(4):
        alpha = jax.random.uniform(jax.random.fold_in(rng, step), (1, 1, 1, 1))
        load_all(gp, dps)
        ld, dg = d_grads(dps, gp, alpha)
        # the port's D step from the same weights
        p_dopt.zero_grad(set_to_none=True)
        fake = p_gen(tx)
        pld = 0.5 * sum(p_disc_loss.get_loss(p_discs[k], fake, ty, alpha=np.array(alpha))
                        for k in ("patch", "full"))
        pld.backward()
        np.testing.assert_allclose(float(pld.detach()), float(ld), rtol=LOSS_RTOL, atol=0)
        for k in ("patch", "full"):
            check_grads(p_discs[k], _grads(p_discs[k]), pd.state_dict_from_jax(dg[k], p_discs[k]))
        feed(p_dopt, [(p_discs[k], _torch_like(pd.state_dict_from_jax(dg[k], p_discs[k]),
                                               p_discs[k])) for k in ("patch", "full")])
        updates, d_state = d_opt.update(dg, d_state)
        dps = optax.apply_updates(dps, updates)
        for k in ("patch", "full"):
            after = _torch_like(pd.state_dict_from_jax(dps[k], p_discs[k]), p_discs[k])
            for n, p in p_discs[k].named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(), rtol=0,
                                           atol=1e-6, err_msg=n)
        # the G step against the updated discriminators
        load_all(gp, dps)
        lg, gg = g_grads(gp, dps)
        p_gopt.zero_grad(set_to_none=True)
        fake = p_gen(tx)
        adv = 0.5 * sum(p_disc_loss.get_g_loss(p_discs[k], fake, ty) for k in ("patch", "full"))
        plg = p_content(fake, ty) + cfg["adv_lambda"] * adv
        plg.backward()
        np.testing.assert_allclose(float(plg.detach()), float(lg), rtol=LOSS_RTOL, atol=0)
        want_g = prg.state_dict_from_jax(gg, n_blocks=1)
        check_grads(p_gen, _grads(p_gen), want_g)
        feed(p_gopt, [(p_gen, _torch_like(want_g, p_gen))])
        updates, g_state = g_opt.update(gg, g_state)
        gp = optax.apply_updates(gp, updates)
        after = _torch_like(prg.state_dict_from_jax(gp, n_blocks=1), p_gen)
        for n, p in p_gen.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), after[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=n)
        assert np.isfinite(float(pld.detach())) and np.isfinite(float(plg.detach()))
        g_losses.append(float(plg.detach()))
    assert g_losses[-1] < g_losses[0]


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_gradient_penalty_on_card_matches_cpu(cuda_device, norm):
    """WGAN-GP's D loss on the card against the CPU: in float32 the loss
    (1e-4 relative); in float64 the loss and every gradient (1e-3 relative
    L2 a tensor). Float32 gradients of the penalty's double backward differ
    by more than that between any two implementations (the CPU's own
    float32 misses float64 so: ``python -m tpuir_torch.utils.gan_precision``)."""
    from tpuir_torch.core.engine import true_float32

    real, fake = _nchw(_signed((2, 64, 64, 3), 60)), _nchw(_signed((2, 64, 64, 3), 61))
    results = {}
    for dtype in (torch.float32, torch.float64):
        for dev in (torch.device("cpu"), cuda_device):
            net = _seeded(pd.NLayerDiscriminator(n_layers=3, norm=norm), 62).to(dev, dtype)
            with true_float32():
                val = pl.DiscLossWGANGP().get_loss(net, fake.to(dev, dtype), real.to(dev, dtype),
                                                   torch.Generator().manual_seed(63))
                val.backward()
            results[dtype, dev.type] = (float(val.detach()),
                                        {k: g.cpu() for k, g in _grads(net).items()})
    for dtype in (torch.float32, torch.float64):
        np.testing.assert_allclose(results[dtype, "cuda"][0], results[dtype, "cpu"][0],
                                   rtol=CARD_LOSS_RTOL, atol=0)
    _assert_grads(results[torch.float64, "cuda"][1], results[torch.float64, "cpu"][1],
                  CARD_GRAD_RTOL)
