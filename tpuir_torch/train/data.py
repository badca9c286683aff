"""Training data: a NumPy copy of ``tpuir/train/data.py`` (BasicSR's data
stack, ``basicsr/data/``), so the same seeds give the same samples bit for
bit: PairedImageDataset with per-task LQ synthesis (seeded val-time AWGN,
``paired_image_dataset.py:90-112``), paired random crop and flip/rotate
augmentation (``transforms.py:26-158``), the epoch-enlarged shuffle
(``data_sampler.py`` EnlargedSampler), and a background thread that stacks
NHWC NumPy batches ahead (``prefetch_dataloader.py``). The pipeline moves
each batch to the model's device as NCHW tensors. ``MixingAugment`` (mixup,
``image_restoration_model.py:22-49``) works on those tensors with tpuir's
draws.

Images are loaded with OpenCV, so the channel order inside the training
path is BGR as in BasicSR; the y-channel metrics expect that.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from glob import glob
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tpuir_torch.registry import DATASET_REGISTRY
from tpuir_torch.utils.natsort import natsorted

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# --------------------------------------------------------------------------
# transforms (BasicSR transforms.py parity)
# --------------------------------------------------------------------------


def paired_random_crop(img_gt, img_lq, gt_patch_size: int, scale: int, rng=random):
    """Paired crop; ``img_gt``/``img_lq`` may each be one array or a list of
    same-size arrays (video frames), like the reference transforms.py:26-95."""
    gt_is_list = isinstance(img_gt, list)
    lq_is_list = isinstance(img_lq, list)
    gts = img_gt if gt_is_list else [img_gt]
    lqs = img_lq if lq_is_list else [img_lq]
    h_lq, w_lq = lqs[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(
            f"LQ ({h_lq}, {w_lq}) smaller than patch size {lq_patch_size}"
        )
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    lqs = [im[top : top + lq_patch_size, left : left + lq_patch_size, ...]
           for im in lqs]
    top_gt, left_gt = top * scale, left * scale
    gts = [im[top_gt : top_gt + gt_patch_size, left_gt : left_gt + gt_patch_size, ...]
           for im in gts]
    return (gts if gt_is_list else gts[0]), (lqs if lq_is_list else lqs[0])


def augment(imgs: List[np.ndarray], hflip=True, rotation=True, rng=random):
    """Random horizontal flip + (vflip, transpose) rotation (transforms.py:96-158)."""
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot = rotation and rng.random() < 0.5

    def _aug(img):
        if do_hflip:
            img = img[:, ::-1, ...]
        if do_vflip:
            img = img[::-1, :, ...]
        if do_rot:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_aug(im) for im in imgs]


class MixingAugment:
    """Mixup between batch samples (image_restoration_model.py:22-49) on
    torch tensors of any layout with the batch first: the draws of
    ``tpuir/train/data.py:MixingAugment`` (NumPy's RandomState) and its
    float32 arithmetic, so the mixed batch equals tpuir's bit for bit."""

    def __init__(self, mixup_beta: float = 1.2, use_identity: bool = True, seed=None):
        self.beta = mixup_beta
        self.use_identity = use_identity
        self.rng = np.random.RandomState(seed)

    def __call__(self, gt, lq):
        if self.use_identity and self.rng.rand() < 1.0 / 3:
            return gt, lq
        lam = self.rng.beta(self.beta, self.beta)
        perm = self.rng.permutation(gt.shape[0])
        idx = torch.as_tensor(perm, device=gt.device)
        return lam * gt + (1 - lam) * gt[idx], lam * lq + (1 - lam) * lq[idx]


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------


def _imread(path: str, flag="color", float32=True):
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("OpenCV required for the training data stack")
    mode = cv2.IMREAD_GRAYSCALE if flag == "grayscale" else cv2.IMREAD_COLOR
    img = cv2.imread(path, mode)
    if img is None:
        raise FileNotFoundError(path)
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imfrombytes(content: bytes, flag="color", float32=False):
    """Decode an image from FileClient bytes (reference utils/img_util.py)."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("OpenCV required for the training data stack")
    mode = cv2.IMREAD_GRAYSCALE if flag == "grayscale" else cv2.IMREAD_COLOR
    img = cv2.imdecode(np.frombuffer(content, np.uint8), mode)
    if img is None:
        raise ValueError("imfrombytes: decode failed")
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def paired_paths_from_folder(lq_folder: str, gt_folder: str, task: Optional[str]):
    gt_paths = natsorted(glob(os.path.join(gt_folder, "*.*")))
    if task in ("denoising_gray", "denoising_color"):  # LQ synthesized from GT
        return [{"gt_path": p, "lq_path": p} for p in gt_paths]
    lq_paths = natsorted(glob(os.path.join(lq_folder, "*.*")))
    assert len(gt_paths) == len(lq_paths), (
        f"paired folder mismatch: {len(gt_paths)} GT vs {len(lq_paths)} LQ"
    )
    return [
        {"gt_path": g, "lq_path": l} for g, l in zip(gt_paths, lq_paths)
    ]


@DATASET_REGISTRY.register()
class PairedImageDataset:
    """Disk-backed paired dataset with per-task LQ synthesis.

    Supported tasks (paired_image_dataset.py:79-119): None (pre-paired
    folders), 'denoising_gray'/'denoising_color' (AWGN synthesized; val
    phase reseeds np.random.seed(0) per item for reproducibility), 'CAR'
    (grayscale pre-paired).
    """

    def __init__(self, opt: Dict):
        self.opt = opt
        self.task = opt.get("task")
        self.noise = opt.get("noise", 0)
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        self.paths = paired_paths_from_folder(
            opt.get("dataroot_lq"), opt["dataroot_gt"], self.task
        )
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict:
        gt_path = self.paths[index]["gt_path"]
        lq_path = self.paths[index]["lq_path"]

        if self.task == "denoising_gray" or self.task == "CAR":
            img_gt = _imread(gt_path, flag="grayscale")[..., None]
            if self.task == "CAR":
                img_lq = _imread(lq_path, flag="grayscale")[..., None]
            else:
                img_lq = self._add_noise(img_gt)
        elif self.task == "denoising_color":
            img_gt = _imread(gt_path)
            img_lq = self._add_noise(img_gt)
        else:
            img_gt = _imread(gt_path)
            img_lq = _imread(lq_path)

        if self.phase == "train":
            gt_size = self.opt["gt_size"]
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, gt_size, self.scale, self.rng
            )
            img_gt, img_lq = augment(
                [img_gt, img_lq],
                self.opt.get("use_hflip", self.opt.get("geometric_augs", False)),
                self.opt.get("use_rot", self.opt.get("geometric_augs", False)),
                self.rng,
            )
        else:
            img_gt = img_gt[
                : img_lq.shape[0] * self.scale, : img_lq.shape[1] * self.scale, :
            ]
        return {
            "lq": np.ascontiguousarray(img_lq, np.float32),
            "gt": np.ascontiguousarray(img_gt, np.float32),
            "lq_path": lq_path,
            "gt_path": gt_path,
        }

    def _add_noise(self, img_gt):
        if self.phase != "train":
            np.random.seed(seed=0)  # val-time determinism (reference :99-111)
        noise = np.random.normal(0, self.noise / 255.0, img_gt.shape)
        return (img_gt.astype(np.float64) + noise).astype(np.float32)


@DATASET_REGISTRY.register(suffix=None)
class Dataset_GaussianDenoising(PairedImageDataset):
    """Fork-B name for the gaussian denoising dataset
    (realDenoising/basicsr/data). sigma_type constant/random/choice."""

    def __init__(self, opt):
        opt = dict(opt)
        sigma_type = opt.get("sigma_type", "constant")
        sigma_range = opt.get("sigma_range", opt.get("sigma_test", 15))
        opt.setdefault("task", "denoising_color" if opt.get("in_ch", 3) == 3 else "denoising_gray")
        self.sigma_type = sigma_type
        self.sigma_range = sigma_range
        if sigma_type == "constant":
            opt["noise"] = sigma_range
        opt.setdefault("noise", opt.get("sigma_test", 0))
        super().__init__(opt)

    def _add_noise(self, img_gt):
        if self.phase == "train":
            if self.sigma_type == "random":
                sigma = np.random.uniform(self.sigma_range[0], self.sigma_range[1])
            elif self.sigma_type == "choice":
                sigma = np.random.choice(self.sigma_range)
            else:
                sigma = self.sigma_range
            self.noise = sigma
        else:
            np.random.seed(seed=0)
        noise = np.random.normal(0, self.noise / 255.0, img_gt.shape)
        return (img_gt.astype(np.float64) + noise).astype(np.float32)


@DATASET_REGISTRY.register(suffix=None)
class Dataset_PairedImage(PairedImageDataset):
    """Fork-B name for the plain paired dataset."""


@DATASET_REGISTRY.register(suffix=None)
class Dataset_DefocusDeblur_DualPixel_16bit:
    """DPDD dual-pixel training dataset: 16-bit L/R input crops stacked to
    6 channels, 16-bit 3-channel target (the dataset type the reference
    DefocusDeblur_DualPixel_16bit_Restormer.yml names; inference-side
    equivalent in tpuir/data/loaders.py:defocus_blur_dataset_loader)."""

    def __init__(self, opt: Dict):
        from tpuir_torch.core.image_io import imread_uint16

        self._imread16 = imread_uint16
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 1)
        gt = natsorted(glob(os.path.join(opt["dataroot_gt"], "*.*")))
        lqL = natsorted(glob(os.path.join(opt["dataroot_lqL"], "*.*")))
        lqR = natsorted(glob(os.path.join(opt["dataroot_lqR"], "*.*")))
        assert len(gt) == len(lqL) == len(lqR), (
            f"DPDD folder mismatch: {len(gt)} GT / {len(lqL)} L / {len(lqR)} R"
        )
        self.paths = list(zip(gt, lqL, lqR))
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict:
        gt_path, lqL_path, lqR_path = self.paths[index]
        img_gt = self._imread16(gt_path).astype(np.float32) / 65535.0
        img_lq = np.concatenate(
            [
                self._imread16(lqL_path).astype(np.float32) / 65535.0,
                self._imread16(lqR_path).astype(np.float32) / 65535.0,
            ],
            axis=2,
        )
        if self.phase == "train":
            gt_size = self.opt["gt_size"]
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, gt_size, self.scale, self.rng
            )
            img_gt, img_lq = augment(
                [img_gt, img_lq],
                self.opt.get("geometric_augs", False),
                self.opt.get("geometric_augs", False),
                self.rng,
            )
        return {
            "lq": np.ascontiguousarray(img_lq, np.float32),
            "gt": np.ascontiguousarray(img_gt, np.float32),
            "lq_path": lqL_path,
            "gt_path": gt_path,
        }


def build_dataset(opt: Dict):
    return DATASET_REGISTRY.get(opt["type"])(opt)


# --------------------------------------------------------------------------
# batching + prefetch
# --------------------------------------------------------------------------


class EnlargedEpochIterator:
    """Epoch-enlarged shuffled batch iterator.

    Equivalent of EnlargedSampler + dataloader (data_sampler.py:6,
    data/__init__.py:40-101): the index space is dataset_enlarge_ratio times
    the dataset, shuffled per epoch with the config seed; batches are
    stacked NHWC NumPy arrays. A background thread prefetches
    (prefetch_dataloader.py equivalent).
    """

    def __init__(self, dataset, batch_size: int, shuffle=True, seed=0,
                 enlarge_ratio: int = 1, drop_last=True, num_prefetch: int = 4,
                 rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.enlarge_ratio = max(1, int(enlarge_ratio))
        self.drop_last = drop_last
        self.num_prefetch = num_prefetch
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) * self.enlarge_ratio // self.world_size
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset) * self.enlarge_ratio
        idx = np.arange(n) % len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = idx[rng.permutation(n)]
        return idx[self.rank :: self.world_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        STOP = object()

        def producer():
            batch = []
            for i in self._indices():
                batch.append(self.dataset[int(i)])
                if len(batch) == self.batch_size:
                    q.put(self._stack(batch))
                    batch = []
            if batch and not self.drop_last:
                q.put(self._stack(batch))
            q.put(STOP)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is STOP:
                break
            yield item

    @staticmethod
    def _stack(items: List[Dict]) -> Dict[str, np.ndarray]:
        return {
            "lq": np.stack([it["lq"] for it in items]),
            "gt": np.stack([it["gt"] for it in items]),
            "lq_path": [it["lq_path"] for it in items],
            "gt_path": [it["gt_path"] for it in items],
        }
