"""Evaluation dataset loaders of the port's harness.

A copy of ``tpuir/data/loaders.py`` on the port's ``config``,
``core/image_io`` and ``utils/natsort``: the same directory layout under
the dataset root (``TPUIR_DATASET_DIR``) and the same iteration:
naturally-sorted file lists, clean images only for the gaussian suites
(the engine adds the noise), SIDD .mat validation blocks (4-D and 5-D
layouts), DPDD single- and dual-pixel inputs (uint16 L and R concatenated
to 6 channels), and motion-blur input/target pairs.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Literal

import numpy as np

from tpuir_torch.config import ROOT_DATASET_DIR
from tpuir_torch.core.image_io import imread_uint8, imread_uint16
from tpuir_torch.utils.natsort import natsorted


class DataLoader:
    """A generator factory with a length."""

    def __init__(self, gen_factory, length: int):
        self._gen_factory = gen_factory
        self._length = int(length)

    def __iter__(self):
        return self._gen_factory()

    def __len__(self):
        return self._length


def _dataset_root():
    return os.environ.get("TPUIR_DATASET_DIR", ROOT_DATASET_DIR)


def gaussian_noise_dataset_loader(
    name: str = "BSD68", n_channels: int = 1
) -> DataLoader:
    dir_path = os.path.join(_dataset_root(), "denoising", "gaussian", "test", name)
    files = natsorted(glob(os.path.join(dir_path, "*.*")))

    def gen():
        for file in files:
            yield imread_uint8(file, n_channels=n_channels), os.path.basename(file)

    return DataLoader(gen, len(files))


def real_noise_dataset_loader(name: str = "SIDD") -> DataLoader:
    import scipy.io as sio

    dir_path = os.path.join(_dataset_root(), "denoising", "real", "test", name)
    noisy = np.asarray(
        sio.loadmat(os.path.join(dir_path, "ValidationNoisyBlocksSrgb.mat"))[
            "ValidationNoisyBlocksSrgb"
        ],
        dtype=np.uint8,
    )
    gt = np.asarray(
        sio.loadmat(os.path.join(dir_path, "ValidationGtBlocksSrgb.mat"))[
            "ValidationGtBlocksSrgb"
        ],
        dtype=np.uint8,
    )
    if noisy.ndim == 4:
        length = noisy.shape[0]

        def gen():
            for i in range(length):
                yield noisy[i], gt[i]

    else:
        N, M = noisy.shape[0], noisy.shape[1]
        length = N * M

        def gen():
            for i in range(N):
                for j in range(M):
                    yield noisy[i, j], gt[i, j]

    return DataLoader(gen, length)


def defocus_blur_dataset_loader(name: str = "DPDD", dual_pixel: bool = False) -> DataLoader:
    dir_path = os.path.join(_dataset_root(), "deblurring", "defocus", "test", name)
    inputC = natsorted(glob(os.path.join(dir_path, "inputC", "*.*")))
    inputL = natsorted(glob(os.path.join(dir_path, "inputL", "*.*")))
    inputR = natsorted(glob(os.path.join(dir_path, "inputR", "*.*")))
    target = natsorted(glob(os.path.join(dir_path, "target", "*.*")))
    length = len(target)

    def gen():
        for i in range(length):
            if dual_pixel:
                input_img = np.concatenate(
                    [imread_uint16(inputL[i]), imread_uint16(inputR[i])], axis=2
                )
                target_img = imread_uint16(target[i])
            else:
                input_img = imread_uint8(inputC[i])
                target_img = imread_uint8(target[i])
            yield input_img, target_img, os.path.basename(inputC[i])

    return DataLoader(gen, length)


def motion_blur_dataset_loader(
    name: Literal["GoPro", "HIDE", "RealBlur_J", "RealBlur_R"] = "GoPro",
) -> DataLoader:
    dir_path = os.path.join(_dataset_root(), "deblurring", "motion", "test", name)
    inputs = natsorted(glob(os.path.join(dir_path, "input", "*.*")))
    targets = natsorted(glob(os.path.join(dir_path, "target", "*.*")))
    length = len(targets)

    def gen():
        for i in range(length):
            yield imread_uint8(inputs[i]), imread_uint8(targets[i]), os.path.basename(
                inputs[i]
            )

    return DataLoader(gen, length)
