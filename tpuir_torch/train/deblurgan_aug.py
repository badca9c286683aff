"""DeblurGANv2's training augmentations: a copy of
``tpuir/train/deblurgan_aug.py`` (the original's ``aug.py`` albumentations
pipelines, rebuilt on NumPy and OpenCV), so one ``RandomState`` gives the
same images bit for bit. ``get_transforms(size, scope, crop)`` is the
paired (image, target) processor, ``get_normalize()`` the paired [-1, 1]
normalizer, ``get_corrupt_function(config)`` the input-only corruption
drawn OneOf from the config's list. OpenCV is optional: where it is
absent, the transforms that need it raise ``RuntimeError``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def _require_cv2():
    if not _HAS_CV2:
        raise RuntimeError("deblurgan_aug requires cv2 for this transform")


# ---------------------------------------------------------------------------
# geometric (paired) transforms
# ---------------------------------------------------------------------------


def _hflip(a, b, rng):
    return a[:, ::-1], b[:, ::-1]


def _transpose(a, b, rng):
    return a.swapaxes(0, 1), b.swapaxes(0, 1)


def _shift_scale_rotate(a, b, rng):
    """albumentations ShiftScaleRotate defaults: shift +-0.0625, scale
    +-0.1, rotate +-45 deg, reflect-101 border."""
    _require_cv2()
    h, w = a.shape[:2]
    angle = rng.uniform(-45, 45)
    scale = 1.0 + rng.uniform(-0.1, 0.1)
    dx = rng.uniform(-0.0625, 0.0625) * w
    dy = rng.uniform(-0.0625, 0.0625) * h
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
    m[0, 2] += dx
    m[1, 2] += dy

    def ap(img):
        return cv2.warpAffine(
            img, m, (w, h), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_REFLECT_101,
        )

    return ap(a), ap(b)


def _grid_distort(a, b, rng, alpha: float):
    """Shared smooth-remap used for the optical/elastic style distortions:
    a coarse random displacement field upsampled to image size."""
    _require_cv2()
    h, w = a.shape[:2]
    gh, gw = 5, 5
    dx = rng.uniform(-alpha, alpha, (gh, gw)).astype(np.float32)
    dy = rng.uniform(-alpha, alpha, (gh, gw)).astype(np.float32)
    dx = cv2.resize(dx, (w, h), interpolation=cv2.INTER_CUBIC)
    dy = cv2.resize(dy, (w, h), interpolation=cv2.INTER_CUBIC)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    mx, my = xx + dx, yy + dy

    def ap(img):
        return cv2.remap(
            img, mx, my, interpolation=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_REFLECT_101,
        )

    return ap(a), ap(b)


def _optical(a, b, rng):
    return _grid_distort(a, b, rng, alpha=max(a.shape[:2]) * 0.02)


def _elastic(a, b, rng):
    return _grid_distort(a, b, rng, alpha=max(a.shape[:2]) * 0.05)


def _pad_if_needed(a, size):
    h, w = a.shape[:2]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return a
    t, l = ph // 2, pw // 2
    return np.pad(a, ((t, ph - t), (l, pw - l), (0, 0)), mode="reflect")


def get_transforms(size: int, scope: str = "geometric",
                   crop: str = "random") -> Callable:
    """aug.py:6-28: scope 'weak' (hflip p=.5) or 'geometric' (OneOf of five
    paired transforms), then pad-if-needed and a random/center crop."""
    geo = [_hflip, _shift_scale_rotate, _transpose, _optical, _elastic]

    def process(a, b, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        if scope == "weak":
            if rng.rand() < 0.5:
                a, b = _hflip(a, b, rng)
        elif scope == "geometric":
            a, b = geo[rng.randint(len(geo))](a, b, rng)
        else:
            raise KeyError(scope)
        a, b = _pad_if_needed(a, size), _pad_if_needed(b, size)
        h, w = a.shape[:2]
        if crop == "random":
            y = rng.randint(h - size + 1)
            x = rng.randint(w - size + 1)
        elif crop == "center":
            y, x = (h - size) // 2, (w - size) // 2
        else:
            raise KeyError(crop)
        return (
            np.ascontiguousarray(a[y : y + size, x : x + size]),
            np.ascontiguousarray(b[y : y + size, x : x + size]),
        )

    return process


def get_normalize() -> Callable:
    """aug.py:31-40: uint8 -> float32 in [-1, 1] (Normalize .5/.5)."""

    def process(a, b):
        def n(x):
            return (x.astype(np.float32) / 255.0 - 0.5) / 0.5

        return n(a), n(b)

    return process


# ---------------------------------------------------------------------------
# input corruptions (aug.py:43-77)
# ---------------------------------------------------------------------------


def _cutout(img, rng, num_holes=8, max_h_size=8, max_w_size=8, **_):
    img = img.copy()
    h, w = img.shape[:2]
    for _ in range(num_holes):
        y, x = rng.randint(h), rng.randint(w)
        y1 = np.clip(y - max_h_size // 2, 0, h)
        y2 = np.clip(y + max_h_size // 2, 0, h)
        x1 = np.clip(x - max_w_size // 2, 0, w)
        x2 = np.clip(x + max_w_size // 2, 0, w)
        img[y1:y2, x1:x2] = 0
    return img


def _jpeg(img, rng, quality_lower=99, quality_upper=100, **_):
    _require_cv2()
    q = int(rng.randint(quality_lower, quality_upper + 1))
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
    return cv2.imdecode(enc, cv2.IMREAD_UNCHANGED).reshape(img.shape)


def _motion_blur(img, rng, blur_limit=7, **_):
    _require_cv2()
    k = int(rng.randint(3, blur_limit + 1)) | 1
    kern = np.zeros((k, k), np.float32)
    x1, x2 = rng.randint(k), rng.randint(k)
    y1, y2 = rng.randint(k), rng.randint(k)
    cv2.line(kern, (x1, y1), (x2, y2), 1.0, thickness=1)
    s = kern.sum()
    kern = kern / s if s > 0 else np.full((k, k), 1.0 / (k * k), np.float32)
    return cv2.filter2D(img, -1, kern)


def _median_blur(img, rng, blur_limit=7, **_):
    _require_cv2()
    k = int(rng.randint(3, blur_limit + 1)) | 1
    return cv2.medianBlur(img, k)


def _gamma(img, rng, gamma_limit=(80, 120), **_):
    g = rng.uniform(gamma_limit[0], gamma_limit[1]) / 100.0
    lut = ((np.arange(256) / 255.0) ** g * 255.0).astype(np.uint8)
    return lut[img]


def _rgb_shift(img, rng, r_shift_limit=20, g_shift_limit=20,
               b_shift_limit=20, **_):
    sh = np.asarray(
        [rng.uniform(-r_shift_limit, r_shift_limit),
         rng.uniform(-g_shift_limit, g_shift_limit),
         rng.uniform(-b_shift_limit, b_shift_limit)], np.float32,
    )
    return np.clip(img.astype(np.float32) + sh, 0, 255).astype(img.dtype)


def _hsv_shift(img, rng, hue_shift_limit=20, sat_shift_limit=30,
               val_shift_limit=20, **_):
    _require_cv2()
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-hue_shift_limit,
                                                 hue_shift_limit))) % 180
    hsv[..., 1] = np.clip(
        hsv[..., 1] + int(rng.uniform(-sat_shift_limit, sat_shift_limit)),
        0, 255,
    )
    hsv[..., 2] = np.clip(
        hsv[..., 2] + int(rng.uniform(-val_shift_limit, val_shift_limit)),
        0, 255,
    )
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def _sharpen(img, rng, alpha=(0.2, 0.5), lightness=(0.5, 1.0), **_):
    _require_cv2()
    a = rng.uniform(*alpha)
    li = rng.uniform(*lightness)
    blur = cv2.GaussianBlur(img.astype(np.float32), (0, 0), 1.0)
    sharp = img.astype(np.float32) * (1 + a * li) - blur * a * li
    return np.clip(sharp, 0, 255).astype(img.dtype)


def _gray(img, rng, **_):
    _require_cv2()
    g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return np.repeat(g[..., None], 3, axis=2)


def _pixelize(img, rng, scale_min=0.25, scale_max=0.25, **_):
    _require_cv2()
    s = rng.uniform(scale_min, scale_max)
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(1, int(w * s)), max(1, int(h * s))),
                       interpolation=cv2.INTER_NEAREST)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


_CORRUPT_FNS = {
    "cutout": _cutout,
    "jpeg": _jpeg,
    "motion_blur": _motion_blur,
    "median_blur": _median_blur,
    "gamma": _gamma,
    "rgb_shift": _rgb_shift,
    "hsv_shift": _hsv_shift,
    "sharpen": _sharpen,
    "gray": _gray,
    "pixelize": _pixelize,
}


def get_corrupt_function(config: List[dict]) -> Callable:
    """aug.py:66-77: OneOf over the configured corruption list, sampled by
    each entry's ``prob`` weight (default .5), applied to the INPUT only."""
    entries = []
    for aug_params in config:
        params = dict(aug_params)
        name = params.pop("name")
        prob = params.pop("prob", 0.5)
        if name not in _CORRUPT_FNS:
            raise KeyError(f"unsupported corruption {name!r}")
        entries.append((_CORRUPT_FNS[name], prob, params))

    probs = np.asarray([p for _, p, _ in entries], np.float64)
    probs = probs / probs.sum()

    def process(x, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        fn, _, params = entries[rng.choice(len(entries), p=probs)]
        return fn(x, rng, **params)

    return process
