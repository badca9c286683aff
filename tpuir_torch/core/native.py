"""Host patch gather and Gaussian blend-stitch for the tiled engine.

ctypes bindings of ``tpuir_torch/csrc/tileblend.cpp``, the port's copy of
the JAX engine's host library, so both engines do the same float32
arithmetic in the same order. The library is built with g++ at first use
into ``build/tpuir_torch/`` at the repository root, keyed by a hash of the
source and flags. A missing compiler, a failed build or a failed load
raises: there is no NumPy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from tpuir_torch.ops._kernels import BUILD_DIR, CSRC_DIR

_SRC = CSRC_DIR / "tileblend.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build():
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libtileblend_{h}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the engine's host library is built from source") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            i64 = ctypes.c_int64
            fp = ctypes.POINTER(ctypes.c_float)
            i64p = ctypes.POINTER(i64)
            lib.extract_patches.argtypes = [fp, i64, i64, i64, i64p, i64, i64, i64, fp]
            lib.extract_patches.restype = None
            lib.blend_accumulate.argtypes = [fp, fp, i64, i64, i64, fp, i64p, i64, i64, i64, fp]
            lib.blend_accumulate.restype = None
            lib.blend_normalize.argtypes = [fp, fp, i64, ctypes.c_float]
            lib.blend_normalize.restype = None
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _coords(coords: Sequence[Tuple[int, int]]) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(coords, np.int64).reshape(-1, 2))


def extract_patches(img: np.ndarray, coords, ph: int, pw: int) -> np.ndarray:
    """img (h, w, c) float32 -> (n, ph, pw, c), patch i at coords[i]."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    cs = _coords(coords)
    if len(cs) and ((cs < 0).any() or (cs[:, 0] + ph > h).any() or (cs[:, 1] + pw > w).any()):
        raise ValueError(f"extract_patches: a ({ph}, {pw}) patch leaves the {h}x{w} image")
    out = np.empty((len(cs), ph, pw, c), np.float32)
    library().extract_patches(_fptr(img), h, w, c, cs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              len(cs), ph, pw, _fptr(out))
    return out


def blend_stitch(preds: np.ndarray, coords, window: np.ndarray, h: int, w: int) -> np.ndarray:
    """preds (n, ph, pw, c) weighted by window (ph, pw, c) -> blended (h, w, c) float32."""
    preds = np.ascontiguousarray(preds, np.float32)
    window = np.ascontiguousarray(window, np.float32)
    n, ph, pw, c = preds.shape
    cs = _coords(coords)
    if len(cs) != n or window.shape != (ph, pw, c):
        raise ValueError(f"blend_stitch: {len(cs)} coords and window {window.shape} "
                         f"for preds {preds.shape}")
    if n and ((cs < 0).any() or (cs[:, 0] + ph > h).any() or (cs[:, 1] + pw > w).any()):
        raise ValueError(f"blend_stitch: a ({ph}, {pw}) patch leaves the {h}x{w} image")
    out = np.zeros((h, w, c), np.float32)
    wmap = np.zeros((h, w, c), np.float32)
    lib = library()
    lib.blend_accumulate(_fptr(out), _fptr(wmap), h, w, c, _fptr(preds),
                         cs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, ph, pw,
                         _fptr(window))
    lib.blend_normalize(_fptr(out), _fptr(wmap), out.size, 1e-8)
    return out
