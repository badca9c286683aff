"""NSS (nested S-shaped) scan index generation for MaIR.

The port's copy of ``tpuir/ops/scan_ids.py`` (pure NumPy), held equal to it
by ``tests/test_torch_nss.py``, plus ``scan_ids_tensor``, which hands the
table to a kernel as an int32 tensor on its device, and
``scan_index_tensors``, the table and its inverse as int64 index tensors
for the gathers around K3. Semantics:

* The image is cut into vertical stripes of width ``scan_len`` (optionally
  preceded by a narrow stripe of width ``shift_len``).
* Within a stripe the path is a boustrophedon: odd rows (after any vertical
  flip) are traversed right-to-left.
* Alternate stripes are traversed bottom-to-top (vertical flip): with no
  shift, stripes 1, 3, ... (0-based, counting the leftmost full stripe as
  0); with a shift, the *even* full stripes are flipped and the narrow lead
  stripe never is.
* The flattened sequence concatenates stripes left to right.

Four directions:
  k=0: scan(grid)            k=1: scan(rot180(grid))
  k=2: scan(grid^T)          k=3: scan(rot180(grid)^T)

The returned ids are row-major positions into the flattened (H, W) image;
``inverse`` is the argsort that undoes the permutation.
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _nss_flatten(grid: np.ndarray, scan_len: int, shift_len: int = 0) -> np.ndarray:
    """Flatten a 2-D grid of values along the NSS path. Returns 1-D array."""
    H, W = grid.shape
    pieces = []
    stripes = []  # (start, end, full_stripe_index or None for the lead stripe)
    if shift_len:
        stripes.append((0, min(shift_len, W), None))
        start = shift_len
    else:
        start = 0
    idx = 0
    s = start
    while s < W:
        e = min(s + scan_len, W)
        stripes.append((s, e, idx))
        s = e
        idx += 1

    for s, e, i in stripes:
        sub = grid[:, s:e]
        if i is not None:
            vflip = (i % 2 == 1) if shift_len == 0 else (i % 2 == 0)
            if vflip:
                sub = sub[::-1, :]
        sub = sub.copy()
        sub[1::2, :] = sub[1::2, ::-1]
        pieces.append(sub.reshape(-1))
    return np.concatenate(pieces) if pieces else np.empty(0, grid.dtype)


@lru_cache(maxsize=256)
def mair_scan_ids(
    H: int, W: int, scan_len: int = 4, shift_len: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(scan_ids, inverse_ids), each int32 of shape (4, H*W)."""
    g = np.arange(H * W, dtype=np.int64).reshape(H, W)
    r = g[::-1, ::-1]  # 180-degree rotation
    ids = np.stack(
        [
            _nss_flatten(g, scan_len, shift_len),
            _nss_flatten(r, scan_len, shift_len),
            _nss_flatten(np.ascontiguousarray(g.T), scan_len, shift_len),
            _nss_flatten(np.ascontiguousarray(r.T), scan_len, shift_len),
        ]
    )
    inverse = np.argsort(ids, axis=-1)
    return ids.astype(np.int32), inverse.astype(np.int32)


_DEVICE_IDS: Dict[tuple, Any] = {}
_DEVICE_IDS_LOCK = threading.Lock()


def scan_ids_tensor(H: int, W: int, scan_len: int, shift_len: int,
                    device: torch.device) -> torch.Tensor:
    """The (4, H*W) scan ids as a contiguous int32 tensor on ``device``.

    Cached per (H, W, scan_len, shift_len, device): a served request shape
    copies its table to the card once. Callers must not write to it.
    """
    key = (H, W, scan_len, shift_len, str(torch.device(device)))
    with _DEVICE_IDS_LOCK:
        ids = _DEVICE_IDS.get(key)
        if ids is None:
            ids = torch.from_numpy(mair_scan_ids(H, W, scan_len, shift_len)[0]).to(device)
            _DEVICE_IDS[key] = ids
    return ids


def scan_index_tensors(H: int, W: int, scan_len: int, shift_len: int,
                       device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scan ids, inverse ids), each a (4, H*W) int64 tensor on ``device``,
    for indexing: ``x[:, ids]`` gathers an image's pixels (B, H*W, d) into
    the four paths' sequences and ``inverse`` puts them back. Cached like
    ``scan_ids_tensor``; callers must not write to them."""
    key = (H, W, scan_len, shift_len, str(torch.device(device)), "index")
    with _DEVICE_IDS_LOCK:
        pair = _DEVICE_IDS.get(key)
        if pair is None:
            pair = tuple(torch.from_numpy(a).long().to(device)
                         for a in mair_scan_ids(H, W, scan_len, shift_len))
            _DEVICE_IDS[key] = pair
    return pair
