"""Optical-flow file IO: a copy of ``tpuir/utils/flow_io.py`` (BasicSR's
``flow_util``): Middlebury ``.flo`` read and write, and the uint8
quantization of flow pairs.
"""

from __future__ import annotations

import numpy as np

_FLO_MAGIC = 202021.25


def flowread(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def flowwrite(flow: np.ndarray, path: str) -> None:
    """Write (H, W, 2) float32 flow as a Middlebury .flo file."""
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_FLO_MAGIC).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.astype(np.float32).tobytes())


def quantize_flow(flow: np.ndarray, max_val: float = 0.02, norm: bool = True):
    """Quantize flow to uint8 pairs (flow_util.quantize_flow semantics)."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    out = []
    for d in (dx, dy):
        d = np.clip(d, -max_val, max_val)
        q = np.floor((d - (-max_val)) / (2 * max_val) * 255).clip(0, 254)
        out.append(q.astype(np.uint8))
    return out


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    dxf = dx.astype(np.float64) * 2 * max_val / 254 - max_val
    dyf = dy.astype(np.float64) * 2 * max_val / 254 - max_val
    if denorm:
        dxf *= dx.shape[1]
        dyf *= dx.shape[0]
    return np.stack([dxf, dyf], axis=-1).astype(np.float32)
