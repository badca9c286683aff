"""No-reference and distribution metrics, NIQE and FID: a copy of
``tpuir/train/extra_metrics.py`` (BasicSR's ``metrics/{niqe,fid}.py``),
NumPy and SciPy, bit for bit.

NIQE (Mittal et al., "Making a 'Completely Blind' Image Quality
Analyzer"): MSCN coefficients, AGGD fits over 96x96 blocks at two scales,
and the distance to a pristine multivariate Gaussian whose parameters
(``mu_pris_param``, ``cov_pris_param``) come from BasicSR's
``niqe_pris_params.npz``: pass its path, or point ``TPUIR_NIQE_PARAMS`` at
it (the file is not in the repository). ``calculate_niqe`` is registered
in the metric registry. FID: the Frechet distance of two feature
Gaussians; the features come from ``train/fid_inception.py``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma

from tpuir_torch.registry import METRIC_REGISTRY


# -- NIQE -------------------------------------------------------------------


def _estimate_aggd_param(block: np.ndarray) -> Tuple[float, float, float]:
    """Estimate AGGD (alpha, beta_l, beta_r) for a block (flattened)."""
    block = block.flatten()
    gam = np.arange(0.2, 10.001, 0.001)
    gam_reciprocal = np.reciprocal(gam)
    r_gam = np.square(gamma(gam_reciprocal * 2)) / (
        gamma(gam_reciprocal) * gamma(gam_reciprocal * 3)
    )

    left_std = np.sqrt(np.mean(block[block < 0] ** 2)) if (block < 0).any() else 0.0
    right_std = np.sqrt(np.mean(block[block > 0] ** 2)) if (block > 0).any() else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block**2) if np.mean(block**2) > 0 else 0
    rhatnorm = (rhat * (gammahat**3 + 1) * (gammahat + 1)) / (
        (gammahat**2 + 1) ** 2
    )
    array_position = np.argmin((r_gam - rhatnorm) ** 2)

    alpha = gam[array_position]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, beta_l, beta_r


def _compute_feature(block: np.ndarray) -> list:
    feat = []
    alpha, beta_l, beta_r = _estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    shifts = [[0, 1], [1, 0], [1, 1], [1, -1]]
    for shift in shifts:
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = _estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def _gaussian_kernel(size: int = 7, sigma: float = 7 / 6) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def niqe_core(
    img: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
    block_size_h: int = 96, block_size_w: int = 96,
) -> float:
    """img: gray float64 [0,255]."""
    img = img.astype(np.float64)
    h, w = img.shape
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    img = img[: num_block_h * block_size_h, : num_block_w * block_size_w]

    distparam = []
    kernel = _gaussian_kernel()
    for scale in (1, 2):
        mu = convolve(img, kernel, mode="nearest")
        sigma = np.sqrt(
            np.abs(convolve(np.square(img), kernel, mode="nearest") - np.square(mu))
        )
        img_norm = (img - mu) / (sigma + 1)

        feats = []
        for idx_w in range(num_block_w):
            for idx_h in range(num_block_h):
                block = img_norm[
                    idx_h * block_size_h // scale : (idx_h + 1) * block_size_h // scale,
                    idx_w * block_size_w // scale : (idx_w + 1) * block_size_w // scale,
                ]
                feats.append(_compute_feature(block))
        distparam.append(np.array(feats))
        if scale == 1:
            from tpuir_torch.utils.matlab_resize import imresize

            img = imresize(img / 255.0, scale=0.5, antialiasing=True) * 255.0

    distparam = np.concatenate(distparam, axis=1)
    mu_distparam = np.nanmean(distparam, axis=0)
    distparam_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(distparam_no_nan, rowvar=False)

    invcov_param = np.linalg.pinv((cov_pris + cov_distparam) / 2)
    diff = mu_pris - mu_distparam
    return float(np.sqrt(diff @ invcov_param @ diff.T))


def _load_pris_params(path: Optional[str] = None):
    path = path or os.environ.get("TPUIR_NIQE_PARAMS")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "NIQE pristine-model params not found; set TPUIR_NIQE_PARAMS to "
            "BasicSR's niqe_pris_params.npz"
        )
    z = np.load(path)
    return z["mu_pris_param"], z["cov_pris_param"]


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border, input_order="HWC", convert_to="y",
                   params_path=None, **kwargs) -> float:
    """img: [0,255] HWC BGR (reference niqe.py surface)."""
    from tpuir_torch.train.metrics import bgr2ycbcr, _reorder

    mu_pris, cov_pris = _load_pris_params(params_path)
    img = _reorder(np.asarray(img), input_order).astype(np.float32)
    if convert_to == "y":
        img = bgr2ycbcr(img / 255.0, y_only=True) * 255.0
    elif convert_to == "gray":
        import cv2

        img = cv2.cvtColor(img / 255.0, cv2.COLOR_BGR2GRAY) * 255.0
    else:
        img = img[..., 0]
    img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe_core(np.round(img), mu_pris, cov_pris)


# -- FID --------------------------------------------------------------------


def calculate_fid_from_stats(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (fid.py equivalent)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))  # tpuir's disp=False: gone in SciPy 1.18
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) feature array -> (mu, sigma)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma
