"""Image IO, normalization, and output dtype restoration (host NumPy).

A copy of ``tpuir/core/image_io.py`` (importing ``tpuir.core`` imports
JAX). OpenCV BGR files are surfaced RGB, grayscale keeps an explicit HW1
channel axis, uint16 supports the dual-pixel path, and restoration outputs
are rounded back to the input dtype. OpenCV (or PIL) is imported only by
the file readers and writers, so the engine runs where neither exists.
"""

from __future__ import annotations

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def imread_uint8(file_path: str, n_channels: int = 3) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        if n_channels == 1:
            img = cv2.imread(file_path, cv2.IMREAD_GRAYSCALE)
            img = np.asarray(img, dtype=np.uint8)
            return np.expand_dims(img, axis=2)
        img = cv2.imread(file_path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return np.asarray(img, dtype=np.uint8)
    from PIL import Image

    img = Image.open(file_path)
    img = img.convert("L" if n_channels == 1 else "RGB")
    arr = np.asarray(img, dtype=np.uint8)
    if n_channels == 1:
        arr = arr[:, :, None]
    return arr


def imread_uint16(file_path: str) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("uint16 image IO requires OpenCV")
    img = cv2.imread(file_path, -1)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return np.asarray(img, dtype=np.uint16)


def imwrite_uint(file_path: str, img: np.ndarray) -> None:
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(file_path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        return
    from PIL import Image

    Image.fromarray(img.squeeze()).save(file_path)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """Scale to float32 [0,1]; float inputs above 1 are scaled by their max."""
    if img.dtype == np.uint16:
        out = img.astype(np.float32) / 65535.0
    elif img.dtype == np.uint8:
        out = img.astype(np.float32) / 255.0
    else:
        max_val = np.max(img)
        out = img.astype(np.float32) / max_val if max_val > 1.0 else img.astype(np.float32)
    return out.astype(np.float32)


def normalize_signed(img: np.ndarray) -> np.ndarray:
    """DeblurGANv2 normalization to [-1, 1]: (x - 127.5) / 127.5 for uint8,
    as the original's albumentations ``Normalize(mean=0.5, std=0.5,
    max_pixel_value=255)``."""
    return ((img.astype(np.float32) / 255.0) - 0.5) / 0.5


def restore_dtype(output_img: np.ndarray, input_img: np.ndarray) -> np.ndarray:
    """Convert the float [0,1] engine output back to the input's dtype."""
    if input_img.dtype == np.uint16:
        return np.clip(output_img * 65535.0, 0, 65535).round().astype(np.uint16)
    if input_img.dtype == np.uint8:
        return np.clip(output_img * 255.0, 0, 255).round().astype(np.uint8)
    min_val = np.min(input_img)
    max_val = np.max(input_img)
    return np.clip(output_img * max_val, min_val, max_val).astype(input_img.dtype)
