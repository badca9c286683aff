"""NSS (nested S-shaped) scan index generation for MaIR.

The port's copy of ``tpuir/ops/scan_ids.py`` (pure NumPy), held equal to it
by ``tests/test_torch_nss.py``, plus ``scan_ids_tensor``, which hands the
table to a kernel as an int32 tensor on its device, and
``scan_index_tensors``, the table and its inverse as int64 index tensors
for the gathers around K3, and the level-1 subchunks of K2's bf16
recurrence (``mair_subchunk_starts``, the kernel's ``mair_subchunk_offsets``
and the plain version's ``mair_subchunk_layout``). Semantics:

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
    ``scan_ids_tensor``; callers must not write to them. Made outside
    inference mode even when first asked for in it (the engine's forward),
    since autograd saves an index for its backward and refuses an
    inference tensor."""
    key = (H, W, scan_len, shift_len, str(torch.device(device)), "index")
    with _DEVICE_IDS_LOCK:
        pair = _DEVICE_IDS.get(key)
        if pair is None:
            with torch.inference_mode(False):
                pair = tuple(torch.from_numpy(a).long().to(device)
                             for a in mair_scan_ids(H, W, scan_len, shift_len))
            _DEVICE_IDS[key] = pair
    return pair


# --- the level-1 subchunks of K2's bf16 recurrence -------------------------
#
# tpuir/ops/nss_stripe.py's recur_bf16 body restarts its bf16 level-1
# recurrence every ``rp`` rows of a stripe (a subchunk) and chains the
# subchunks' float32 carries in sequence order. In the compact sequence a
# stripe of width w and length n (n = H for directions 0 and 1, W for 2 and
# 3) is n rows of w positions in walk order, so its subchunks are runs of
# rp * w positions: 16 in a full stripe, 8 in a shifted half-width lead or
# tail stripe at MaIR's scan_len 4 and vert_p 16. A row-reversed stripe
# walks its subchunks in reverse, but rp divides n, so the boundaries still
# fall every rp rows of the walk.


def subchunk_rows(n: int, scan_len: int, vert_p: int = 16) -> int:
    """rp, the rows of a level-1 subchunk of a stripe of length n: even,
    dividing n, as near vert_p // scan_len as it can be (the rule of
    ``tpuir/ops/nss_stripe.py:_seg_params``; its segment count moves no
    boundary)."""
    rp = max(2, (vert_p // scan_len) // 2 * 2)
    while n % rp:
        rp -= 2
    return rp


def _stripe_widths(cols: int, scan_len: int, shift_len: int):
    """The widths of the stripes of a grid ``cols`` wide, left to right, as
    ``_nss_flatten`` cuts them."""
    widths = [min(shift_len, cols)] if shift_len else []
    s = shift_len
    while s < cols:
        widths.append(min(scan_len, cols - s))
        s += scan_len
    return widths


def _class_dims(H: int, W: int, k: int) -> Tuple[int, int]:
    """(stripe length, grid width) of direction k's oriented grid."""
    return (H, W) if k < 2 else (W, H)


@lru_cache(maxsize=256)
def mair_subchunk_starts(H: int, W: int, scan_len: int = 4, shift_len: int = 0,
                         vert_p: int = 16) -> np.ndarray:
    """(4, H*W) uint8: 1 where direction k's compact sequence starts a
    level-1 subchunk (``ids`` of ``mair_scan_ids`` order), else 0. Position
    0 of every direction is a start."""
    starts = np.zeros((4, H * W), np.uint8)
    for k in range(4):
        n, cols = _class_dims(H, W, k)
        rp = subchunk_rows(n, scan_len, vert_p)
        t = 0
        for w in _stripe_widths(cols, scan_len, shift_len):
            starts[k, t:t + n * w:rp * w] = 1
            t += n * w
    return starts


@lru_cache(maxsize=256)
def mair_subchunk_layout(H: int, W: int, scan_len: int = 4, shift_len: int = 0,
                         vert_p: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """(layout, count): ``layout`` (4, S, P) int64 lists each direction's
    subchunks in sequence order, slot p of subchunk s holding the compact
    position it scans, or -1 past a short subchunk's end and past a
    direction's last subchunk (identity steps of the recurrence; P is the
    longest subchunk, S the most subchunks of a direction); ``count`` (4,)
    the subchunks of each direction."""
    runs = []
    for k in range(4):
        n, cols = _class_dims(H, W, k)
        rows = subchunk_rows(n, scan_len, vert_p)
        runs.append([rows * w for w in _stripe_widths(cols, scan_len, shift_len)
                     for _ in range(n // rows)])
    S = max(len(r) for r in runs)
    P = max(max(r) for r in runs)
    layout = np.full((4, S, P), -1, np.int64)
    for k, r in enumerate(runs):
        t = 0
        for s, m in enumerate(r):
            layout[k, s, :m] = np.arange(t, t + m)
            t += m
    return layout, np.array([len(r) for r in runs], np.int64)


def mair_subchunk_offsets(H: int, W: int, scan_len: int = 4, shift_len: int = 0,
                          vert_p: int = 16) -> np.ndarray:
    """(4, S + 1) int32: where each of direction k's subchunks starts in its
    compact sequence (the marks of ``mair_subchunk_starts``, in order),
    padded with H*W past its last one; S is the most subchunks of a
    direction."""
    starts = mair_subchunk_starts(H, W, scan_len, shift_len, vert_p)
    firsts = [np.flatnonzero(row) for row in starts]
    off = np.full((4, max(len(f) for f in firsts) + 1), H * W, np.int32)
    for k, f in enumerate(firsts):
        off[k, :len(f)] = f
    return off


def subchunk_offsets_tensor(H: int, W: int, scan_len: int, shift_len: int,
                            device: torch.device, vert_p: int = 16) -> torch.Tensor:
    """``mair_subchunk_offsets`` as a contiguous int32 tensor on ``device``,
    cached as ``scan_ids_tensor`` caches the ids. Callers must not write to
    it."""
    key = (H, W, scan_len, shift_len, str(torch.device(device)), "offsets", vert_p)
    with _DEVICE_IDS_LOCK:
        t = _DEVICE_IDS.get(key)
        if t is None:
            t = torch.from_numpy(mair_subchunk_offsets(H, W, scan_len, shift_len, vert_p)).to(
                device)
            _DEVICE_IDS[key] = t
    return t
