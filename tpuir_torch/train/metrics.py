"""Framework validation metrics: a NumPy copy of ``tpuir/train/metrics.py``
(BasicSR's ``calculate_psnr`` / ``calculate_ssim``, ``metrics/psnr_ssim.py``,
with ``crop_border`` and ``test_y_channel``; the Y channel by the BT.601
``bgr2ycbcr`` of ``utils/matlab_functions.py``): images in [0, 255],
Matlab's SSIM (11x11 Gaussian, sigma 1.5, the valid region). Registered in
METRIC_REGISTRY under BasicSR's names, so option files work unchanged.
"""

from __future__ import annotations

import numpy as np

from tpuir_torch.registry import METRIC_REGISTRY


def _reorder(img: np.ndarray, input_order: str) -> np.ndarray:
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    if img.ndim == 2:
        return img[..., None]
    return img


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """img float in [0, 1], BGR order -> float in [0, 1] range YCbCr.

    Matches matlab_functions.bgr2ycbcr float-input semantics
    (matlab_functions.py:214-246): the BT.601 transform is computed on the
    0-255 scale and the float result is divided back by 255."""
    if y_only:
        return (np.dot(img, [24.966, 128.553, 65.481]) + 16.0) / 255.0
    mat = np.array(
        [
            [24.966, 112.0, -18.214],
            [128.553, -74.203, -93.786],
            [65.481, -37.797, 112.0],
        ]
    )
    return (np.matmul(img, mat) + [16, 128, 128]) / 255.0


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    if y_only:
        return (np.dot(img, [65.481, 128.553, 24.966]) + 16.0) / 255.0
    return bgr2ycbcr(img[..., ::-1], y_only=False)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """[0,255] HWC BGR -> [0,255] Y channel HW1 (metric_util.to_y_channel)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0


def _prep(img, img2, crop_border, input_order, test_y_channel):
    assert img.shape == img2.shape, f"shapes differ: {img.shape} vs {img2.shape}"
    img = _reorder(np.asarray(img), input_order).astype(np.float64)
    img2 = _reorder(np.asarray(img2), input_order).astype(np.float64)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img, img2


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order="HWC",
                   test_y_channel=False, **kwargs) -> float:
    img, img2 = _prep(img, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _gaussian_kernel11() -> np.ndarray:
    # cv2.getGaussianKernel(11, 1.5): normalized samples of exp(-x^2/(2*1.5^2))
    x = np.arange(11, dtype=np.float64) - 5
    k = np.exp(-(x**2) / (2 * 1.5**2))
    k /= k.sum()
    return np.outer(k, k)


def _ssim_channel(img: np.ndarray, img2: np.ndarray) -> float:
    from scipy.signal import convolve2d

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    window = _gaussian_kernel11()
    filt = lambda x: convolve2d(x, window, mode="valid")  # noqa: E731

    mu1 = filt(img)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(img**2) - mu1_sq
    sigma2_sq = filt(img2**2) - mu2_sq
    sigma12 = filt(img * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order="HWC",
                   test_y_channel=False, **kwargs) -> float:
    img, img2 = _prep(img, img2, crop_border, input_order, test_y_channel)
    return float(
        np.mean([_ssim_channel(img[..., i], img2[..., i]) for i in range(img.shape[2])])
    )


def calculate_metric(data: dict, opt: dict) -> float:
    """Registry dispatch, mirroring basicsr.metrics.calculate_metric."""
    opt = dict(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
