"""The extra datasets of BasicSR's fork: a single folder (FFHQ-style),
per-clip video test folders, and the REDS and Vimeo90K training sets.

A copy of ``tpuir/train/video_datasets.py`` on the port's data stack
(``train/data.py``, ``train/file_client.py``), so the same seeds give the
same samples bit for bit: NHWC float32 BGR NumPy arrays in [0, 1], as
every dataset of ``train/data.py`` yields. Importing ``tpuir_torch.train``
registers them.
"""

from __future__ import annotations

import os
import random
from glob import glob
from typing import Dict, List

import numpy as np

from tpuir_torch.registry import DATASET_REGISTRY
from tpuir_torch.train.data import _imread, augment, imfrombytes, paired_random_crop
from tpuir_torch.train.file_client import FileClient
from tpuir_torch.utils.flow_io import dequantize_flow
from tpuir_torch.utils.natsort import natsorted


@DATASET_REGISTRY.register()
class FFHQDataset:
    """Flat GT-only folder; returns {'gt': HWC float32 BGR [0,1]}."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.paths = natsorted(glob(os.path.join(opt["dataroot_gt"], "*.*")))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict:
        img = _imread(self.paths[index])
        return {"gt": np.ascontiguousarray(img, np.float32),
                "gt_path": self.paths[index]}


@DATASET_REGISTRY.register()
class VideoTestDataset:
    """Per-clip frame folders: dataroot_lq/<clip>/*.png paired with
    dataroot_gt/<clip>/*.png. Yields one frame (+ neighbors) at a time."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.num_frame = opt.get("num_frame", 1)
        lq_root, gt_root = opt["dataroot_lq"], opt["dataroot_gt"]
        self.items: List = []
        for clip in natsorted(os.listdir(lq_root)):
            lq_frames = natsorted(glob(os.path.join(lq_root, clip, "*.*")))
            gt_frames = natsorted(glob(os.path.join(gt_root, clip, "*.*")))
            for i in range(len(gt_frames)):
                self.items.append((clip, i, lq_frames, gt_frames))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict:
        clip, i, lq_frames, gt_frames = self.items[index]
        half = self.num_frame // 2
        idxs = [min(max(i + d, 0), len(lq_frames) - 1)
                for d in range(-half, half + 1)]
        lq = np.stack([_imread(lq_frames[j]) for j in idxs])
        if self.num_frame == 1:
            lq = lq[0]
        gt = _imread(gt_frames[i])
        return {
            "lq": np.ascontiguousarray(lq, np.float32),
            "gt": np.ascontiguousarray(gt, np.float32),
            "lq_path": lq_frames[i],
            "gt_path": gt_frames[i],
            "folder": clip,
            "idx": f"{i}/{len(gt_frames)}",
        }

@DATASET_REGISTRY.register()
class REDSDataset:
    """REDS training dataset (reference realDenoising/basicsr/data/
    reds_dataset.py:12-237): meta-info-keyed clips of 100 frames, REDS4 or
    official validation partition removed, temporal interval + random
    reverse augmentation, optional quantized-flow side channel, paired
    random crop and flip/rotate.

    Returns NHWC float32 BGR in [0,1]: {'lq': (T,H,W,C), 'gt': (H,W,C),
    'key'} plus 'flow': (T,H,W,2) when dataroot_flow is set.
    """

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.flow_root = opt.get("dataroot_flow")
        if opt["num_frame"] % 2 != 1:
            raise ValueError(
                f"num_frame should be odd number, but got {opt['num_frame']}"
            )
        self.num_frame = opt["num_frame"]
        self.num_half_frames = opt["num_frame"] // 2

        self.keys: List[str] = []
        with open(opt["meta_info_file"]) as fin:
            for line in fin:
                folder, frame_num, _ = line.split(" ")
                self.keys.extend(
                    f"{folder}/{i:08d}" for i in range(int(frame_num))
                )
        val_partition_t = opt["val_partition"]
        if val_partition_t == "REDS4":
            val_partition = ["000", "011", "015", "020"]
        elif val_partition_t == "official":
            val_partition = [f"{v:03d}" for v in range(240, 270)]
        else:
            raise ValueError(
                f"Wrong validation partition {val_partition_t}."
                f"Supported ones are ['official', 'REDS4']."
            )
        self.keys = [v for v in self.keys if v.split("/")[0] not in val_partition]

        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.is_lmdb = self.io_backend_opt["type"] == "lmdb"
        if self.is_lmdb:
            if self.flow_root is not None:
                self.io_backend_opt["db_paths"] = [
                    self.lq_root, self.gt_root, self.flow_root
                ]
                self.io_backend_opt["client_keys"] = ["lq", "gt", "flow"]
            else:
                self.io_backend_opt["db_paths"] = [self.lq_root, self.gt_root]
                self.io_backend_opt["client_keys"] = ["lq", "gt"]

        self.interval_list = opt["interval_list"]
        self.random_reverse = opt["random_reverse"]
        self.rng = opt.get("rng", random)

    def _read(self, client_key: str, lmdb_key: str, disk_path: str,
              flag: str = "color", float32: bool = True):
        path = lmdb_key if self.is_lmdb else disk_path
        return imfrombytes(
            self.file_client.get(path, client_key), flag=flag, float32=float32
        )

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict:
        if self.file_client is None:
            opts = dict(self.io_backend_opt)
            self.file_client = FileClient(opts.pop("type"), **opts)

        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]
        clip_name, frame_name = key.split("/")
        center_frame_idx = int(frame_name)

        # temporal augmentation: random interval, re-center if out of clip
        interval = self.rng.choice(self.interval_list)
        start = center_frame_idx - self.num_half_frames * interval
        end = center_frame_idx + self.num_half_frames * interval
        while start < 0 or end > 99:  # each clip has frames 0..99
            center_frame_idx = self.rng.randint(0, 99)
            start = center_frame_idx - self.num_half_frames * interval
            end = center_frame_idx + self.num_half_frames * interval
        frame_name = f"{center_frame_idx:08d}"
        neighbor_list = list(range(start, end + 1, interval))
        if self.random_reverse and self.rng.random() < 0.5:
            neighbor_list.reverse()

        img_gt = self._read(
            "gt", f"{clip_name}/{frame_name}",
            os.path.join(self.gt_root, clip_name, f"{frame_name}.png"),
        )
        img_lqs = [
            self._read(
                "lq", f"{clip_name}/{n:08d}",
                os.path.join(self.lq_root, clip_name, f"{n:08d}.png"),
            )
            for n in neighbor_list
        ]

        img_flows = []
        if self.flow_root is not None:
            # previous then next flows; stored as stacked-uint8 (dx; dy)
            names = [f"{frame_name}_p{i}" for i in
                     range(self.num_half_frames, 0, -1)]
            names += [f"{frame_name}_n{i}" for i in
                      range(1, self.num_half_frames + 1)]
            for n in names:
                cat = self._read(
                    "flow", f"{clip_name}/{n}",
                    os.path.join(self.flow_root, clip_name, f"{n}.png"),
                    flag="grayscale", float32=False,
                )
                dx, dy = np.split(cat, 2, axis=0)
                img_flows.append(dequantize_flow(dx, dy, max_val=20, denorm=False))
            img_lqs.extend(img_flows)

        img_gt, img_lqs = paired_random_crop(
            img_gt, img_lqs, gt_size, scale, rng=self.rng
        )
        if self.flow_root is not None:
            img_lqs, img_flows = (
                img_lqs[: self.num_frame], img_lqs[self.num_frame :]
            )

        img_lqs.append(img_gt)
        if self.flow_root is not None:
            # the reference augments flows jointly (sign-flipping dx/dy on
            # flips); do the same with the shared flip draws
            do_h = self.opt["use_flip"] and self.rng.random() < 0.5
            do_v = self.opt["use_rot"] and self.rng.random() < 0.5
            do_r = self.opt["use_rot"] and self.rng.random() < 0.5

            def _aug_img(im):
                if do_h:
                    im = im[:, ::-1, ...]
                if do_v:
                    im = im[::-1, :, ...]
                if do_r:
                    im = im.transpose(1, 0, 2)
                return np.ascontiguousarray(im)

            def _aug_flow(fl):
                if do_h:
                    fl = fl[:, ::-1, :].copy()
                    fl[:, :, 0] *= -1
                if do_v:
                    fl = fl[::-1, :, :].copy()
                    fl[:, :, 1] *= -1
                if do_r:
                    fl = fl.transpose(1, 0, 2)
                    fl = fl[:, :, [1, 0]]
                return np.ascontiguousarray(fl)

            img_results = [_aug_img(im) for im in img_lqs]
            img_flows = [_aug_flow(fl) for fl in img_flows]
        else:
            img_results = augment(
                img_lqs, self.opt["use_flip"], self.opt["use_rot"], rng=self.rng
            )

        lq = np.stack(img_results[:-1]).astype(np.float32)
        gt = np.ascontiguousarray(img_results[-1], np.float32)
        out = {"lq": lq, "gt": gt, "key": key}
        if self.flow_root is not None:
            # insert the zero center flow (reference reds_dataset.py:224-227)
            img_flows.insert(
                self.num_half_frames, np.zeros_like(img_flows[0])
            )
            out["flow"] = np.stack(img_flows).astype(np.float32)
        return out


@DATASET_REGISTRY.register()
class Vimeo90KDataset:
    """Vimeo90K septuplet training dataset (reference
    realDenoising/basicsr/data/vimeo90k_dataset.py:10-130): GT is the
    center frame im4.png; LQ is a num_frame window centered on it;
    random-reverse temporal augmentation, paired crop, flip/rotate.

    Returns {'lq': (T,H,W,C) float32 BGR, 'gt': (H,W,C), 'key'}.
    """

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        with open(opt["meta_info_file"]) as fin:
            self.keys = [line.split(" ")[0] for line in fin]

        self.file_client = None
        self.io_backend_opt = dict(opt["io_backend"])
        self.is_lmdb = self.io_backend_opt["type"] == "lmdb"
        if self.is_lmdb:
            self.io_backend_opt["db_paths"] = [self.lq_root, self.gt_root]
            self.io_backend_opt["client_keys"] = ["lq", "gt"]

        # frame window centered on im4 (1-indexed im1..im7)
        self.neighbor_list = [
            i + (9 - opt["num_frame"]) // 2 for i in range(opt["num_frame"])
        ]
        self.random_reverse = opt["random_reverse"]
        self.rng = opt.get("rng", random)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict:
        if self.file_client is None:
            opts = dict(self.io_backend_opt)
            self.file_client = FileClient(opts.pop("type"), **opts)

        if self.random_reverse and self.rng.random() < 0.5:
            self.neighbor_list.reverse()

        scale = self.opt["scale"]
        gt_size = self.opt["gt_size"]
        key = self.keys[index]
        clip, seq = key.split("/")

        gt_path = (
            f"{key}/im4" if self.is_lmdb
            else os.path.join(self.gt_root, clip, seq, "im4.png")
        )
        img_gt = imfrombytes(self.file_client.get(gt_path, "gt"), float32=True)
        img_lqs = []
        for neighbor in self.neighbor_list:
            lq_path = (
                f"{clip}/{seq}/im{neighbor}" if self.is_lmdb
                else os.path.join(self.lq_root, clip, seq, f"im{neighbor}.png")
            )
            img_lqs.append(
                imfrombytes(self.file_client.get(lq_path, "lq"), float32=True)
            )

        img_gt, img_lqs = paired_random_crop(
            img_gt, img_lqs, gt_size, scale, rng=self.rng
        )
        img_lqs.append(img_gt)
        img_results = augment(
            img_lqs, self.opt["use_flip"], self.opt["use_rot"], rng=self.rng
        )
        return {
            "lq": np.stack(img_results[:-1]).astype(np.float32),
            "gt": np.ascontiguousarray(img_results[-1], np.float32),
            "key": key,
        }
