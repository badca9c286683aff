"""Training logging: MessageLogger with ETA, timers, TensorBoard, as
``tpuir/train/logging_utils.py`` has them (BasicSR ``utils/logger.py``).

The TensorBoard writer is ``torch.utils.tensorboard``'s where that imports,
else none; wandb is optional. ``get_env_info`` reports torch and CUDA.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Dict, Optional

from tpuir_torch.parallel.dist import get_dist_info


class AvgTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self) -> float:
        return self.current_time

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """Iter/epoch/lr/time/ETA/loss formatting (BasicSR logger.py:45-117)."""

    def __init__(self, opt: Dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        logger_opt = opt.get("logger") or {}
        self.interval = logger_opt.get("print_freq", 100)
        self.start_iter = start_iter
        self.max_iters = (opt.get("train") or {}).get("total_iter", 0)
        self.use_tb_logger = logger_opt.get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    def __call__(self, log_vars: Dict):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch")
        lrs = log_vars.pop("lrs")

        message = (
            f"[{self.exp_name[:31]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        )
        for v in lrs:
            message += f"{v:.3e},"
        message += ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            log_vars.pop("data_time", None)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f}] "

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None:
                self.tb_logger.add_scalar(
                    f"losses/{k}" if k.startswith("l_") else k, v, current_iter
                )
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # pragma: no cover
        return None
    return SummaryWriter(log_dir=log_dir)


def init_wandb_logger(opt: Dict):  # pragma: no cover - optional dependency
    try:
        import wandb
    except ImportError:
        return None
    w = (opt.get("logger") or {}).get("wandb") or {}
    wandb.init(project=w.get("project"), resume="allow", id=w.get("resume_id"))
    return wandb


_root_logger_initialized = False


def get_root_logger(
    logger_name: str = "tpuir_torch", log_level=logging.INFO, log_file: Optional[str] = None
):
    """The port's logger; on a rank other than 0 of a process group it
    reports errors only and writes no file (BasicSR's ``get_root_logger``)."""
    global _root_logger_initialized
    logger = logging.getLogger(logger_name)
    if not _root_logger_initialized:
        fmt = "%(asctime)s %(levelname)s: %(message)s"
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.setLevel(log_level)
        logger.propagate = False
        _root_logger_initialized = True
    if get_dist_info()[0] != 0:
        logger.setLevel(logging.ERROR)
    elif log_file is not None and not any(
        isinstance(h, logging.FileHandler) for h in logger.handlers
    ):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger


def get_env_info() -> str:
    import torch

    cuda = (f"{torch.version.cuda}, {torch.cuda.device_count()} x "
            f"{torch.cuda.get_device_name(0)}" if torch.cuda.is_available() else "none")
    return (
        f"\n\ttpuir_torch"
        f"\n\tPyTorch: {torch.__version__}"
        f"\n\tCUDA: {cuda}"
    )
