"""Training losses: ``tpuir/train/losses.py`` in PyTorch (BasicSR's loss zoo,
``basicsr/losses/losses.py``).

Every loss is a function (pred, target[, weight]) -> a scalar tensor (or
unreduced with ``reduction="none"``), with the ``reduction`` and
elementwise-weight semantics of BasicSR's ``@weighted_loss``
(``loss_util.py:15-52``) in :func:`weighted_loss`. Images are NCHW, as in
BasicSR (tpuir's are NHWC): a one-channel weight broadcasts over dim 1, and
the total variation and the Y channel read H, W and C where NCHW keeps
them.
"""

from __future__ import annotations

import inspect
import math
from functools import partial

import torch
import torch.nn.functional as F


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(reduction)


def weighted_loss(elementwise, pred, target, weight=None, reduction="mean"):
    loss = elementwise(pred, target)
    if weight is not None:
        loss = loss * weight
    if weight is None or reduction == "sum":
        return _reduce(loss, reduction)
    if reduction == "mean":
        # the mean over the weighted region (loss_util.py:44-52): the weight
        # sum, times the channels where a one-channel weight broadcasts
        denom = weight.sum()
        if loss.dim() >= 2 and weight.shape[1] == 1 and loss.shape[1] > 1:
            denom = denom * loss.shape[1]
        return loss.sum() / denom
    return loss  # 'none' with weight: weighted, unreduced


def l1_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    return loss_weight * weighted_loss(
        lambda p, t: (p - t).abs(), pred, target, weight, reduction)


def mse_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    return loss_weight * weighted_loss(
        lambda p, t: (p - t) ** 2, pred, target, weight, reduction)


def charbonnier_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean",
                     eps=1e-12):
    return loss_weight * weighted_loss(
        lambda p, t: torch.sqrt((p - t) ** 2 + eps), pred, target, weight, reduction)


def psnr_loss(pred, target, loss_weight=1.0, to_y=False):
    """Negative PSNR (BasicSR PSNRLoss)."""
    if to_y:
        coef = pred.new_tensor([65.481, 128.553, 24.966]).reshape(1, 3, 1, 1) / 255.0
        pred = (pred * coef).sum(1, keepdim=True) + 16.0 / 255.0
        target = (target * coef).sum(1, keepdim=True) + 16.0 / 255.0
    mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    return loss_weight * ((10.0 / math.log(10.0)) * torch.log(mse + 1e-8)).mean()


def weighted_tv_loss(pred, weight=None, loss_weight=1.0):
    """WeightedTVLoss: L1 total variation (losses.py WeightedTVLoss)."""
    wy = None if weight is None else weight[:, :, :-1, :]
    wx = None if weight is None else weight[:, :, :, :-1]
    y = l1_loss(pred[:, :, :-1, :], pred[:, :, 1:, :], weight=wy)
    x = l1_loss(pred[:, :, :, :-1], pred[:, :, :, 1:], weight=wx)
    return loss_weight * (x + y)


# -- GAN losses (BasicSR GANLoss, losses.py:~300-420) ------------------------


def gan_loss(pred, target_is_real: bool, gan_type: str = "vanilla",
             real_label_val: float = 1.0, fake_label_val: float = 0.0,
             is_disc: bool = False, loss_weight: float = 1.0):
    if gan_type == "vanilla":
        label = real_label_val if target_is_real else fake_label_val
        loss = (pred.clamp_min(0) - pred * label + torch.log1p(torch.exp(-pred.abs()))).mean()
    elif gan_type == "lsgan":
        label = real_label_val if target_is_real else fake_label_val
        loss = ((pred - label) ** 2).mean()
    elif gan_type == "wgan":
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == "wgan_softplus":
        loss = F.softplus(-pred).mean() if target_is_real else F.softplus(pred).mean()
    elif gan_type == "hinge":
        if is_disc:
            p = -pred if target_is_real else pred
            loss = F.relu(1 + p).mean()
        else:
            loss = -pred.mean()
    else:
        raise NotImplementedError(f"GAN type {gan_type}")
    return loss if is_disc else loss * loss_weight


def multi_scale_gan_loss(preds, target_is_real: bool, gan_type: str = "vanilla",
                         real_label_val: float = 1.0, fake_label_val: float = 0.0,
                         is_disc: bool = False, loss_weight: float = 1.0):
    """MultiScaleGANLoss (losses.py:364-389): ``preds`` is a list of
    per-scale predictions (or of per-layer lists, of which the last enters
    the loss); the mean over scales. A bare tensor is :func:`gan_loss`."""
    if isinstance(preds, (list, tuple)):
        total = 0.0
        for pred_i in preds:
            if isinstance(pred_i, (list, tuple)):
                pred_i = pred_i[-1]
            total = total + gan_loss(pred_i, target_is_real, gan_type, real_label_val,
                                     fake_label_val, is_disc, loss_weight)
        return total / len(preds)
    return gan_loss(preds, target_is_real, gan_type, real_label_val, fake_label_val,
                    is_disc, loss_weight)


def gan_feat_loss(pred_fake, pred_real, criterion: str = "l1",
                  loss_weight: float = 1.0, reduction: str = "mean"):
    """Feature-matching loss (losses.py:460-492): per-discriminator lists of
    per-layer features, the last entry (the prediction) left out; the real
    features are detached. ``loss_weight`` is applied inside the criterion
    and again to the total, as the published loss does."""
    ops = {"l1": l1_loss, "l2": mse_loss, "charbonnier": charbonnier_loss}
    if criterion not in ops:
        raise ValueError(f"Unsupported loss mode: {criterion}. Supported ones are: "
                         "l1|l2|charbonnier")
    op = ops[criterion]
    num_d = len(pred_fake)
    loss = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            loss = loss + op(pred_fake[i][j], pred_real[i][j].detach(),
                             loss_weight=loss_weight, reduction=reduction) / num_d
    return loss * loss_weight


def g_path_regularize(path_grad, mean_path_length, decay: float = 0.01):
    """StyleGAN2 path-length regularizer (losses.py:409-419), given
    ``path_grad`` = d((fake*noise).sum())/d(latents), (B, n_latents,
    latent_dim). Returns (path_penalty, path_lengths_mean,
    updated_mean_path_length), the last two detached."""
    path_lengths = torch.sqrt((path_grad ** 2).sum(2).mean(1))
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    path_penalty = ((path_lengths - path_mean.detach()) ** 2).mean()
    return path_penalty, path_lengths.mean().detach(), path_mean.detach()


def r1_penalty(real_grad, real_img=None):
    """R1 gradient penalty given d(D)/d(real) (losses.py r1_penalty)."""
    return (real_grad ** 2).sum(dim=(1, 2, 3)).mean()


def gradient_penalty(interp_grad, weight=None):
    """WGAN-GP penalty given d(D)/d(interpolates)."""
    if weight is not None:
        interp_grad = interp_grad * weight
    norm = torch.sqrt((interp_grad ** 2).sum(dim=(1, 2, 3)) + 1e-12)
    return ((norm - 1.0) ** 2).mean()


LOSS_REGISTRY = {
    "L1Loss": l1_loss,
    "MSELoss": mse_loss,
    "CharbonnierLoss": charbonnier_loss,
    "PSNRLoss": psnr_loss,
    "WeightedTVLoss": weighted_tv_loss,
    "GANLoss": gan_loss,
    "MultiScaleGANLoss": multi_scale_gan_loss,
    "GANFeatLoss": gan_feat_loss,
}


def build_loss(opt: dict):
    """A loss closure from a BasicSR loss opt dict (``basicsr/losses/__init__.py``
    ``build_loss``): ``type`` picks the loss, the other keys become keyword
    arguments. GAN losses are called as ``loss(pred, target_is_real,
    is_disc=...)``, ``GANFeatLoss`` as ``loss(pred_fake, pred_real)``."""
    opt = dict(opt)
    fn = LOSS_REGISTRY[opt.pop("type")]
    unknown = set(opt) - set(inspect.signature(fn).parameters)
    if unknown:
        raise ValueError(f"unknown option keys for {fn.__name__}: {sorted(unknown)}")
    return partial(fn, **opt)
