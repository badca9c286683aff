"""DeblurGANv2's own PSNR/SSIM pair and image glue.

The PyTorch counterpart of ``tpuir/train/deblurgan_metrics.py``: the
original's ``util/metrics.py`` (an SSIM of the map mean with an 11x11
Gaussian window, sigma 1.5, over [0, 1] tensors, zero padding, no data
range) and ``models/models.py:19-31`` (``tensor2im``,
``get_images_and_metrics``). The SSIM runs on the tensors' device as a
depthwise ``F.conv2d``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpuir_torch.core.metrics import calculate_metrics


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM of two NCHW float tensors: depthwise 11x11 Gaussian moments,
    zero padding 5, C1/C2 for unit range; a 0-d tensor."""
    c = img1.shape[1]
    w = torch.as_tensor(_gaussian_window(), device=img1.device)[None, None].repeat(c, 1, 1, 1)

    def blur(x):
        return F.conv2d(x, w, padding=5, groups=c)

    img1, img2 = img1.float(), img2.float()
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(m)


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """uint8-range inputs scored on [0, 1]."""
    mse = float(np.mean((img1 / 255.0 - img2 / 255.0) ** 2))
    if mse == 0:
        return 100.0
    return 20 * math.log10(1.0 / math.sqrt(mse))


def tensor2im(image: torch.Tensor, imtype=np.uint8) -> np.ndarray:
    """The first element of an NCHW [-1, 1] tensor as a uint8 HWC image."""
    img = image[0].detach().cpu().float().numpy().transpose(1, 2, 0)
    img = (img + 1) / 2.0 * 255.0
    return img.astype(imtype)


def get_images_and_metrics(inp, output, target):
    """(psnr, ssim, hstack of input, output and target): tpuir's triple, the
    SSIM the harness's on the uint8 images."""
    i, f, r = tensor2im(inp), tensor2im(output), tensor2im(target)
    p = psnr(f, r)
    _, s = calculate_metrics(f, r)
    return p, s, np.hstack((i, f, r))
