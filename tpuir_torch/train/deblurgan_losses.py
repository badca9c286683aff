"""DeblurGANv2's training losses (content and adversarial) and ImagePool.

The PyTorch counterpart of ``tpuir/train/deblurgan_losses.py``. A
discriminator is an ``nn.Module`` (tpuir passes ``(apply_fn, params)``);
every loss returns a scalar float32 tensor on the inputs' device, and its
gradients come from ``backward``. ``get_loss`` reads the same config keys:
content_loss in {'perceptual', 'l1'}, disc_loss in {'wgan-gp', 'lsgan',
'gan', 'ragan', 'ragan-ls'}.

WGAN-GP's penalty is a gradient of a gradient: ``torch.autograd.grad`` of
D's summed output at the interpolate, with ``create_graph=True``, so the
loss's backward runs through D's backward again. Its interpolation
coefficient is one value a call, drawn from an explicit ``torch.Generator``
or passed in (``alpha=``, as tpuir's ``alpha=``); with neither, it is the
first draw of a generator seeded 0, as tpuir then draws from
``PRNGKey(0)``.

The relativistic losses keep pools of detached predictions, as the
original's torch ImagePool does; here they stay on the device, so a step
does not wait for the host. Their draws (``random.sample``) are tpuir's.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuir_torch.train.vgg_features import (IMAGENET_MEAN, IMAGENET_STD, VGG19Conv33,
                                            load_vgg19_features)
from tpuir_torch.utils.misc import resolve_device


class ImagePool:
    """A deque of detached tensors, one a batch element; ``query``
    samples up to ``pool_size`` of them (``util/image_pool.py:8-33``)."""

    def __init__(self, pool_size: int = 50):
        self.pool_size = pool_size
        self.sample_size = pool_size
        self.images: deque = deque()

    def add(self, images: torch.Tensor):
        if self.pool_size == 0:
            return images
        for image in images.detach():
            if len(self.images) >= self.pool_size:
                self.images.popleft()
            self.images.append(image[None])

    def query(self) -> torch.Tensor:
        if len(self.images) > self.sample_size:
            imgs = random.sample(list(self.images), self.sample_size)
        else:
            imgs = list(self.images)
        return torch.cat(imgs, 0)


# -- content losses ------------------------------------------------------------


class ContentLoss:
    """Mean absolute error (the factory's L1 criterion)."""

    def __call__(self, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(fake - real))


class PerceptualLoss:
    """VGG19 conv3_3 MSE (x0.006) plus pixel MSE (x0.5).

    Inputs are NCHW in [-1, 1]. As the original (``losses.py:49-50``),
    both are mapped to [0, 1] and then ONLY batch element 0 is
    ImageNet-normalized; the feature pass and the pixel MSE both see that
    tensor. The real image's features carry no gradient."""

    def __init__(self, vgg: nn.Module):
        self.vgg = vgg

    @staticmethod
    def _prep(im: torch.Tensor) -> torch.Tensor:
        im = (im + 1.0) / 2.0
        mean = torch.as_tensor(IMAGENET_MEAN, device=im.device).view(3, 1, 1)
        std = torch.as_tensor(IMAGENET_STD, device=im.device).view(3, 1, 1)
        return torch.cat([((im[0] - mean) / std)[None], im[1:]], dim=0)

    def __call__(self, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        fake, real = self._prep(fake), self._prep(real)
        f_fake = self.vgg(fake)
        f_real = self.vgg(real).detach()
        return 0.006 * torch.mean((f_fake - f_real) ** 2) + 0.5 * torch.mean((fake - real) ** 2)


# -- adversarial losses --------------------------------------------------------


def _gan_criterion(pred: torch.Tensor, target: float, use_l1: bool) -> torch.Tensor:
    """L1 to the label, or BCE with logits in tpuir's form."""
    if use_l1:
        return torch.mean(torch.abs(pred - target))
    return torch.mean(torch.clamp(pred, min=0.0) - pred * target
                      + torch.log1p(torch.exp(-torch.abs(pred))))


class DiscLoss:
    """Vanilla GAN, BCE criterion."""

    use_l1 = False

    def get_g_loss(self, d: nn.Module, fakeB, realB):
        return _gan_criterion(d(fakeB), 1.0, self.use_l1)

    def get_loss(self, d: nn.Module, fakeB, realB):
        loss_fake = _gan_criterion(d(fakeB.detach()), 0.0, self.use_l1)
        loss_real = _gan_criterion(d(realB), 1.0, self.use_l1)
        return (loss_fake + loss_real) * 0.5

    def __call__(self, d, fakeB, realB):
        return self.get_loss(d, fakeB, realB)


class DiscLossLS(DiscLoss):
    """LSGAN: the L1 criterion against the labels."""

    use_l1 = True


class DiscLossWGANGP(DiscLossLS):
    """WGAN-GP, the released configs' default: one interpolation
    coefficient a call, and the gradient's norm over channels at each
    position with tpuir's ``+ 1e-16`` inside the square root."""

    LAMBDA = 10.0

    def get_g_loss(self, d: nn.Module, fakeB, realB):
        return -torch.mean(d(fakeB))

    @staticmethod
    def draw_alpha(generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The interpolation coefficient, (1, 1, 1, 1), on the generator's device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return torch.rand((1, 1, 1, 1), generator=generator, device=generator.device)

    def calc_gradient_penalty(self, d: nn.Module, real, fake,
                              generator: Optional[torch.Generator] = None, alpha=None):
        if alpha is None:
            alpha = self.draw_alpha(generator)
        alpha = torch.as_tensor(alpha, dtype=real.dtype).to(real.device)
        interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
        (grads,) = torch.autograd.grad(d(interp).sum(), interp, create_graph=True)
        gnorm = torch.sqrt(torch.sum(grads ** 2, dim=1) + 1e-16)
        return torch.mean((gnorm - 1.0) ** 2) * self.LAMBDA

    def get_loss(self, d: nn.Module, fakeB, realB,
                 generator: Optional[torch.Generator] = None, alpha=None):
        fakeB = fakeB.detach()
        wass = torch.mean(d(fakeB)) - torch.mean(d(realB))
        return wass + self.calc_gradient_penalty(d, realB, fakeB, generator, alpha)

    def __call__(self, d, fakeB, realB, generator=None, alpha=None):
        return self.get_loss(d, fakeB, realB, generator, alpha)


class RelativisticDiscLoss:
    """RaGAN: predictions centered on the mean of the opposite pool. With
    ``fake_mean`` and ``real_mean`` given, ``get_loss`` neither reads nor
    updates the pools (tpuir's explicit-means path); call ``update_pools``
    after the step then."""

    use_l1 = False

    def __init__(self, pool_size: int = 50):
        self.fake_pool = ImagePool(pool_size)
        self.real_pool = ImagePool(pool_size)

    def pool_means(self):
        """(fake_mean, real_mean), 0-d tensors on the pools' device."""
        f, r = self.fake_pool.query(), self.real_pool.query()
        fm = f.mean() if f.numel() else f.new_zeros(())
        rm = r.mean() if r.numel() else r.new_zeros(())
        return fm, rm

    @torch.no_grad()
    def update_pools(self, d: nn.Module, fakeB, realB):
        self.fake_pool.add(d(fakeB.detach()))
        self.real_pool.add(d(realB))

    def _g_terms(self, pred_fake, pred_real, fake_mean, real_mean):
        return (_gan_criterion(pred_real - fake_mean, 0.0, self.use_l1)
                + _gan_criterion(pred_fake - real_mean, 1.0, self.use_l1)) / 2.0

    def _d_terms(self, pred_fake, pred_real, fake_mean, real_mean):
        return (_gan_criterion(pred_real - fake_mean, 1.0, self.use_l1)
                + _gan_criterion(pred_fake - real_mean, 0.0, self.use_l1)) / 2.0

    def get_g_loss(self, d: nn.Module, fakeB, realB, fake_mean=None, real_mean=None):
        pred_fake, pred_real = d(fakeB), d(realB)
        if fake_mean is None or real_mean is None:
            fake_mean, real_mean = self.pool_means()
        return self._g_terms(pred_fake, pred_real, fake_mean, real_mean)

    def get_loss(self, d: nn.Module, fakeB, realB, fake_mean=None, real_mean=None):
        fakeB = fakeB.detach()
        explicit = fake_mean is not None and real_mean is not None
        if not explicit:
            self.update_pools(d, fakeB, realB)
        pred_fake, pred_real = d(fakeB), d(realB)
        if not explicit:
            fake_mean, real_mean = self.pool_means()
        return self._d_terms(pred_fake, pred_real, fake_mean, real_mean)

    def __call__(self, d, fakeB, realB, **kw):
        return self.get_loss(d, fakeB, realB, **kw)


class RelativisticDiscLossLS(RelativisticDiscLoss):
    """RaLSGAN: squared distance to +-1 around the opposite pool's mean."""

    def _g_terms(self, pred_fake, pred_real, fake_mean, real_mean):
        return (torch.mean((pred_real - fake_mean + 1.0) ** 2)
                + torch.mean((pred_fake - real_mean - 1.0) ** 2)) / 2.0

    def _d_terms(self, pred_fake, pred_real, fake_mean, real_mean):
        return (torch.mean((pred_real - fake_mean - 1.0) ** 2)
                + torch.mean((pred_fake - real_mean + 1.0) ** 2)) / 2.0


def get_loss(model_config: dict, vgg_state_dict=None, device="cuda"):
    """(content_loss, disc_loss) from the model config (``losses.py:279-300``).
    'perceptual' needs a torchvision VGG19 state dict (``vgg_state_dict``)
    and builds the trunk on ``device`` (default card 0; raises without one)."""
    cl = model_config["content_loss"]
    if cl == "perceptual":
        if vgg_state_dict is None:
            raise ValueError("content_loss='perceptual' needs VGG19 weights "
                             "(a torchvision vgg19 state dict)")
        vgg = load_vgg19_features(VGG19Conv33(), vgg_state_dict)
        content = PerceptualLoss(vgg.to(resolve_device(device)).requires_grad_(False))
    elif cl == "l1":
        content = ContentLoss()
    else:
        raise ValueError(f"ContentLoss [{cl}] not recognized.")

    losses = {"wgan-gp": DiscLossWGANGP, "lsgan": DiscLossLS, "gan": DiscLoss,
              "ragan": RelativisticDiscLoss, "ragan-ls": RelativisticDiscLossLS}
    dl = model_config["disc_loss"]
    if dl not in losses:
        raise ValueError(f"GAN Loss [{dl}] not recognized.")
    return content, losses[dl]()
