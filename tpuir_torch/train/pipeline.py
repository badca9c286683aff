"""Train and test pipelines: ``tpuir/train/pipeline.py``'s loops (BasicSR's
``train.py:99-220`` and ``test.py:14-55``) on the port's model wrappers.

The epoch and iteration loop, the lr schedule set on the optimizer each
step, the progressive-learning batch shaper, periodic validation (with
the two-stage frequency) and checkpoints, and ``--auto_resume`` from the
newest training state. Each batch goes to the model's device as NCHW
tensors (``model.feed``) before the progressive crop.
"""

from __future__ import annotations

import glob
import os
import random
import time
from typing import Dict, Optional

import numpy as np

from tpuir_torch.train.data import EnlargedEpochIterator, build_dataset
from tpuir_torch.train.logging_utils import (
    AvgTimer,
    MessageLogger,
    get_env_info,
    get_root_logger,
    init_tb_logger,
)
from tpuir_torch.train.model import build_model
from tpuir_torch.train.options import dict2str


def load_resume_state(opt: Dict) -> Optional[str]:
    """Pick the max-iter .state under training_states (train.py:76-96)."""
    if opt.get("auto_resume"):
        state_dir = opt["path"]["training_states"]
        if os.path.isdir(state_dir):
            states = glob.glob(os.path.join(state_dir, "*.state"))
            if states:
                return max(states, key=lambda p: float(os.path.basename(p)[:-6]))
    return opt["path"].get("resume_state")


def create_train_val_dataloader(opt: Dict, logger):
    train_loader, val_loaders = None, []
    for phase, dataset_opt in (opt.get("datasets") or {}).items():
        if phase == "train":
            ds = build_dataset(dataset_opt)
            train_loader = EnlargedEpochIterator(
                ds,
                batch_size=dataset_opt.get("batch_size_per_gpu", 8),
                shuffle=dataset_opt.get("use_shuffle", True),
                seed=opt.get("manual_seed", 0),
                enlarge_ratio=dataset_opt.get("dataset_enlarge_ratio", 1),
                rank=opt.get("rank", 0),
                world_size=opt.get("world_size", 1),
            )
            logger.info(
                f"Training set [{dataset_opt.get('name')}]: {len(ds)} images, "
                f"{len(train_loader)} iters/epoch"
            )
        elif phase.split("_")[0] in ("val", "test"):
            ds = build_dataset(dataset_opt)
            val_loaders.append(
                (
                    dataset_opt.get("name", phase),
                    EnlargedEpochIterator(
                        ds, batch_size=1, shuffle=False, drop_last=False
                    ),
                )
            )
    return train_loader, val_loaders


class ProgressiveSchedule:
    """Progressive-learning batch shaper (reference realDenoising
    basicsr/train.py:216-273): the training run is split into stages by
    cumulative ``iters``; stage j draws ``mini_batch_sizes[j]`` samples
    from the loader batch and takes a random ``gt_sizes[j]`` crop. Enabled
    only when the train dataset opt carries all three keys (the Restormer
    and MaIR-RealDN training configs do)."""

    def __init__(self, ds_opt: Dict, scale: int = 1, seed: int = 0):
        self.iters = ds_opt.get("iters")
        self.batch_sizes = ds_opt.get("mini_batch_sizes")
        self.gt_sizes = ds_opt.get("gt_sizes")
        self.gt_size = ds_opt.get("gt_size")
        self.batch = ds_opt.get("batch_size_per_gpu", 8)
        self.scale = scale
        self.enabled = bool(self.iters and self.batch_sizes and self.gt_sizes)
        self.groups = np.cumsum(self.iters) if self.enabled else None
        self.rng = random.Random(seed)
        self._announced = set()

    def stage(self, current_iter: int) -> int:
        j = int(np.searchsorted(self.groups, current_iter, side="left"))
        return min(j, len(self.groups) - 1)

    def __call__(self, batch: Dict, current_iter: int, logger=None) -> Dict:
        """The stage's batch of NCHW tensors ``lq``, ``gt``."""
        if not self.enabled:
            return batch
        j = self.stage(current_iter)
        mini_gt, mini_bs = int(self.gt_sizes[j]), int(self.batch_sizes[j])
        if logger is not None and j not in self._announced:
            self._announced.add(j)
            logger.info(
                f"Progressive stage {j}: patch {mini_gt}, batch {mini_bs}"
            )
        lq, gt = batch["lq"], batch["gt"]
        if mini_bs < lq.shape[0]:
            idx = self.rng.sample(range(lq.shape[0]), k=mini_bs)
            lq, gt = lq[idx], gt[idx]
        if self.gt_size and mini_gt < self.gt_size:
            # NCHW as BasicSR crops (train.py:266-272): x0 on H, y0 on W,
            # the pixels tpuir's NHWC crop takes
            x0 = int((self.gt_size - mini_gt) * self.rng.random())
            y0 = int((self.gt_size - mini_gt) * self.rng.random())
            lq = lq[:, :, x0 : x0 + mini_gt, y0 : y0 + mini_gt]
            s = self.scale
            gt = gt[:, :, x0 * s : (x0 + mini_gt) * s, y0 * s : (y0 + mini_gt) * s]
        out = dict(batch)
        out["lq"], out["gt"] = lq.contiguous(), gt.contiguous()
        return out


def train_pipeline(root_path: str, opt: Dict) -> Dict:
    logger = get_root_logger(
        log_file=None
        if not opt["path"].get("log")
        else _log_file(opt)
    )
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    tb_logger = None
    if (opt.get("logger") or {}).get("use_tb_logger") and opt.get("rank", 0) == 0:
        tb_logger = init_tb_logger(os.path.join(root_path, "tb_logger", opt["name"]))

    train_loader, val_loaders = create_train_val_dataloader(opt, logger)
    model = build_model(opt)

    start_epoch, current_iter = 0, 0
    resume_state = load_resume_state(opt)
    if resume_state:
        info = model.resume_training(resume_state)
        start_epoch, current_iter = info["epoch"], info["iter"]
        logger.info(f"Resuming from epoch {start_epoch}, iter {current_iter}")

    total_iter = opt["train"]["total_iter"]
    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    logger.info(f"Start training from epoch {start_epoch}, iter {current_iter}")

    val_opt = opt.get("val") or {}
    logger_opt = opt.get("logger") or {}
    progressive = ProgressiveSchedule(
        (opt.get("datasets") or {}).get("train") or {},
        scale=opt.get("scale", 1),
        seed=opt.get("manual_seed", 0) or 0,
    )
    epoch = start_epoch
    done = current_iter >= total_iter
    while not done:
        train_loader.set_epoch(epoch)
        data_timer.start()
        iter_timer.start()
        for batch in train_loader:
            data_timer.record()
            if current_iter >= total_iter:
                done = True
                break
            current_iter += 1
            batch = progressive(model.feed(batch), current_iter, logger)
            log_vars = model.optimize_parameters(batch)
            iter_timer.record()
            if current_iter == 1:
                msg_logger.reset_start_time()
            if current_iter % logger_opt.get("print_freq", 100) == 0:
                msg_logger(
                    {
                        "epoch": epoch,
                        "iter": current_iter,
                        "lrs": [model.current_lr],
                        "time": iter_timer.get_avg_time(),
                        "data_time": data_timer.get_avg_time(),
                        **log_vars,
                    }
                )
            if current_iter % logger_opt.get("save_checkpoint_freq", 5000) == 0:
                logger.info("Saving models and training states.")
                model.save(epoch, current_iter)
            # two-stage validation frequency (reference trainF.py:204-214):
            # val_freq before val_milestone, val_freq_final after
            val_freq = val_opt.get("val_freq")
            if val_opt.get("val_milestone") and current_iter >= int(
                val_opt["val_milestone"]
            ):
                val_freq = val_opt.get("val_freq_final", val_freq)
            if val_freq and current_iter % int(val_freq) == 0:
                for name, loader in val_loaders:
                    metrics = model.validation(
                        loader,
                        current_iter,
                        save_img=val_opt.get("save_img", False),
                        rgb2bgr=val_opt.get("rgb2bgr", True),
                        use_image=val_opt.get("use_image", True),
                    )
                    logger.info(f"Validation {name} @ {current_iter}: {metrics}")
                    if tb_logger:
                        for k, v in metrics.items():
                            tb_logger.add_scalar(f"metrics/{name}/{k}", v, current_iter)
            data_timer.start()
            iter_timer.start()
        epoch += 1

    logger.info("End of training. Saving the latest model.")
    model.save(epoch, current_iter)
    if tb_logger:
        tb_logger.close()
    return {"epoch": epoch, "iter": current_iter, "model": model}


def test_pipeline(root_path: str, opt: Dict) -> Dict[str, Dict[str, float]]:
    logger = get_root_logger()
    logger.info(get_env_info())
    _, val_loaders = create_train_val_dataloader(opt, logger)
    model = build_model(opt)
    val_opt = opt.get("val") or {}
    all_metrics = {}
    for name, loader in val_loaders:
        metrics = model.validation(
            loader,
            save_img=val_opt.get("save_img", False),
            rgb2bgr=val_opt.get("rgb2bgr", True),
            use_image=val_opt.get("use_image", True),
        )
        logger.info(f"Test {name}: {metrics}")
        all_metrics[name] = metrics
    return all_metrics


def _log_file(opt):
    log_dir = opt["path"].get("log")
    if not log_dir:
        return None
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(
        log_dir, f"train_{opt['name']}_{time.strftime('%Y%m%d_%H%M%S')}.log"
    )
