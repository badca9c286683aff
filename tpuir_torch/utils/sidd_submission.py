"""SIDD benchmark submission packaging: a copy of
``tpuir/utils/sidd_submission.py``. The restored sRGB blocks go back into
the (N, M) object layout of ValidationNoisyBlocksSrgb and out as
``SubmitSrgb.mat`` (``DenoisedBlocksSrgb``, ``TimeMPSrgb``).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np

from tpuir_torch.core.image_io import imread_uint8
from tpuir_torch.utils.natsort import natsorted


def bundle_srgb_submission(
    results_dir: str,
    out_dir: Optional[str] = None,
    n_images: int = 40,
    n_blocks: int = 32,
) -> str:
    """results_dir holds the engine's per-block PNGs (row-major over
    (image, block), the order the SIDD loader yields them). Writes
    SubmitSrgb.mat with key 'DenoisedBlocksSrgb'."""
    import scipy.io as sio

    out_dir = out_dir or results_dir
    files = natsorted(glob(os.path.join(results_dir, "*.png")))
    if len(files) != n_images * n_blocks:
        raise ValueError(
            f"expected {n_images * n_blocks} block images, found {len(files)}"
        )
    blocks = np.empty((n_images, n_blocks), dtype=object)
    for idx, path in enumerate(files):
        i, j = divmod(idx, n_blocks)
        blocks[i, j] = imread_uint8(path)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "SubmitSrgb.mat")
    sio.savemat(out_path, {"DenoisedBlocksSrgb": blocks, "TimeMPSrgb": 0.0})
    return out_path
