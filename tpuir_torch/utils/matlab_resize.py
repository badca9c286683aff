"""MATLAB's bicubic imresize (antialiased), NumPy: a copy of
``tpuir/utils/matlab_resize.py`` (BasicSR's ``matlab_functions.imresize``),
bit for bit. The cubic kernel (a=-0.5) widens by 1/scale when
downscaling, the weights are renormalized, and the borders replicate by
folding the indices. NIQE's half-scale step uses it.
"""

from __future__ import annotations

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2
    ) * ((ax > 1) & (ax <= 2))


def _weights_indices(in_len: int, out_len: int, scale: float, antialiasing: bool):
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based columns +1 later
    dist = u[:, None] - (indices + 1)
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # trim all-zero first/last columns (MATLAB does the same)
    if not np.any(weights[:, 0]):
        indices = indices[:, 1:]
        weights = weights[:, 1:]
        p -= 1
    if not np.any(weights[:, -1]):
        indices = indices[:, :-1]
        weights = weights[:, :-1]
        p -= 1
    # replicate borders via symmetric index folding
    indices = indices.astype(np.int64)
    aux = np.concatenate(
        [np.arange(in_len), np.arange(in_len - 1, -1, -1)]
    )
    indices = aux[np.mod(indices, aux.size)]
    return weights, indices


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """img: HW or HWC float (any range) or uint8; returns float64 (uint8 in
    -> float64 in [0,255] domain), matching the reference semantics."""
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    in_h, in_w, c = img.shape
    out_h = int(np.ceil(in_h * scale))
    out_w = int(np.ceil(in_w * scale))
    imgf = img.astype(np.float64)

    wh, ih = _weights_indices(in_h, out_h, scale, antialiasing)
    ww, iw = _weights_indices(in_w, out_w, scale, antialiasing)

    # rows: out1[o, w, c] = sum_p wh[o, p] * img[ih[o, p], w, c]
    out1 = np.einsum("op,opwc->owc", wh, imgf[ih, :, :])
    # cols: out2[h, o, c] = sum_p ww[o, p] * out1[h, iw[o, p], c]
    out2 = np.einsum("op,hopc->hoc", ww, out1[:, iw, :])
    if squeeze:
        out2 = out2[:, :, 0]
    return out2
