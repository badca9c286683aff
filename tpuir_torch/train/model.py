"""Model lifecycle wrappers: ``tpuir/train/model.py``'s SRModel, MambaIRModel,
MaIRPlusModel and ImageCleanModel (BasicSR's ``models/``, Restormer's
``image_restoration_model.py``) on the port's networks.

A wrapper owns the network and its weights (seeded, or a released
``.pth`` read with ``torch.load(weights_only=True)`` and
``load_state_dict``), the loss, the optimizer and schedule, the EMA, the
train step (``train/trainer.py``), validation with the registry metrics
(forwards under ``torch.no_grad()``, so MaIR validates through its
kernels), and checkpoints in BasicSR's format: ``net_g_{iter}.pth`` and
``net_g_ema_{iter}.pth`` ({'params': state_dict}), ``{iter}.state``
(epoch, iter, step, the parameters, the optimizer's state and the EMA),
each written with tpuir's retry loop. So a trained checkpoint is served by
``tpuir_torch.zoo`` as a released one is.

The device is ``cuda:0`` unless the caller asks for another (``device=``,
or the option dict's ``device``, which ``parse_options`` sets from
``--device`` and the launcher); without a card, ``cuda`` raises.

Under a launcher (``opt["dist"]``: one process a GPU in a
``torch.distributed`` group, ``parallel/dist.py``) the training forward
runs through ``DistributedDataParallel`` around ``net_g``, which averages
the gradients of the ranks' shares over the group, so that W ranks on B/W
samples each take the step one process takes on B; the logged loss is the
mean over the ranks. ``net_g`` itself keeps the state dict (no
``module.`` prefix), the EMA, validation and the checkpoints, which rank 0
alone writes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpuir_torch.parallel.dist import master_only
from tpuir_torch.registry import MODEL_REGISTRY
from tpuir_torch.train import archs
from tpuir_torch.train.data import MixingAugment
from tpuir_torch.train.losses import build_loss
from tpuir_torch.train.metrics import calculate_metric
from tpuir_torch.train.schedulers import build_scheduler
from tpuir_torch.train.trainer import TrainState, build_optimizer, train_step
from tpuir_torch.utils.misc import resolve_device


def to_nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An NHWC NumPy batch as an NCHW float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous().to(device)


def _write_with_retry(path: str, write_fn, retries: int = 3) -> None:
    """Retry a failed checkpoint write, then warn and move on: BasicSR's
    'avoid occasional writing errors' loop (``base_model.py:225-240``)."""
    logger = logging.getLogger("tpuir_torch")
    for attempt in range(retries):
        try:
            write_fn(path)
            return
        except Exception as e:  # noqa: BLE001 -- BasicSR's loop catches everything
            logger.warning("Save model error: %s, remaining retry times: %d",
                           e, retries - attempt - 1)
            time.sleep(1)
    logger.warning("Still cannot save %s. Just ignore it.", path)


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """A BasicSR network file: {'params': state_dict} on the CPU."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    _write_with_retry(path, lambda p: torch.save({"params": sd}, p))


def load_params(path: str, param_key: str = "params") -> Dict[str, torch.Tensor]:
    """A network file's state dict: ``param_key``, else ``params_ema``, else
    ``params``, else the file itself (BasicSR's ``load_network``,
    ``base_model.py:277-303``), with any ``module.`` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in (param_key, "params_ema", "params"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k[7:] if k.startswith("module.") else k: v for k, v in ckpt.items()}


@MODEL_REGISTRY.register()
class SRModel:
    """Single-network restoration model (BasicSR ``sr_model.py:14-281``)."""

    def __init__(self, opt: Dict, device=None):
        self.opt = opt
        self.device = resolve_device(device or opt.get("device"))
        self.is_train = opt.get("is_train", False)
        self.network_opt = dict(opt["network_g"])
        self.net_type = self.network_opt["type"]
        self.net_g = archs.build_network(self.network_opt)
        self.state: Optional[TrainState] = None
        self.log_dict: Dict = {}

        load_path = (opt.get("path") or {}).get("pretrain_network_g")
        if load_path:
            self.load_network(load_path, opt["path"].get("param_key_g", "params"))
        else:
            self.net_g.load_state_dict(
                archs.init_state_dict(self.network_opt, opt.get("manual_seed", 0) or 0))
        self.net_g.to(self.device)
        if self.is_train:
            self.init_training_settings()

    # -- weights ----------------------------------------------------------

    def load_network(self, path: str, param_key: str = "params") -> None:
        """Load a ``.pth`` network file (the port's checkpoints or a released
        one) into ``net_g``, in place."""
        self.net_g.load_state_dict(load_params(path, param_key))

    # -- training ---------------------------------------------------------

    def init_training_settings(self) -> None:
        train_opt = self.opt["train"]
        self.ema_decay = train_opt.get("ema_decay", 0)
        self.cri_pix = build_loss(train_opt.get("pixel_opt", {"type": "L1Loss"}))
        optim_opt = dict(train_opt["optim_g"])
        sched_opt = train_opt.get("scheduler", {"type": "MultiStepLR", "milestones": [10**9]})
        self.schedule = build_scheduler(optim_opt.get("lr", 2e-4), sched_opt)
        self.net_g.train()
        forward_net = None
        if self.opt.get("dist"):
            from torch.nn.parallel import DistributedDataParallel

            forward_net = DistributedDataParallel(
                self.net_g, device_ids=[self.device] if self.device.type == "cuda" else None)
        self.state = TrainState(
            self.net_g, build_optimizer(optim_opt, [p for p in self.net_g.parameters()]),
            self.schedule, ema_decay=self.ema_decay or None, forward_net=forward_net)
        self.grad_clip = 0.01 if train_opt.get("use_grad_clip") else None
        self.mixing_flag = bool((train_opt.get("mixing_augs") or {}).get("mixup", False))
        if self.mixing_flag:
            ma = train_opt["mixing_augs"]
            self.mixing_augmentation = MixingAugment(
                ma.get("mixup_beta", 1.2), ma.get("use_identity", True),
                seed=self.opt.get("manual_seed"))

    def feed(self, batch: Dict) -> Dict:
        """The batch with ``lq`` and ``gt`` as NCHW tensors on the device."""
        out = dict(batch)
        for key in ("lq", "gt"):
            if isinstance(out[key], np.ndarray):
                out[key] = to_nchw(out[key], self.device)
        return out

    def optimize_parameters(self, batch: Dict) -> Dict[str, float]:
        batch = self.feed(batch)
        lq, gt = batch["lq"], batch["gt"]
        if self.is_train and self.mixing_flag:
            gt, lq = self.mixing_augmentation(gt, lq)
        metrics = train_step(self.state, lq, gt, self.cri_pix, self.grad_clip)
        loss = metrics["loss"]
        if self.opt.get("dist"):  # the mean over the ranks (BasicSR's reduce_loss_dict)
            loss = loss.clone()
            torch.distributed.all_reduce(loss)
            loss /= torch.distributed.get_world_size()
        self.log_dict = {"l_pix": float(loss)}
        return self.log_dict

    @property
    def current_lr(self) -> float:
        return float(self.schedule(self.state.step))

    # -- inference / validation -------------------------------------------

    def _eval_net(self) -> torch.nn.Module:
        """The network to evaluate: a copy holding the EMA weights where
        training keeps them, else ``net_g``."""
        if self.state is not None and self.state.ema is not None:
            net = archs.build_network(self.network_opt).to(self.device)
            net.load_state_dict(self.state.ema_state_dict())
            return net
        return self.net_g

    @torch.no_grad()
    def test(self, lq: torch.Tensor, net: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """A plain forward of one NCHW batch."""
        return (net or self._eval_net())(lq.to(self.device))

    def pad_test(self, lq: torch.Tensor, window_size: int,
                 net: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """Reflect-pad H, W to a multiple of ``window_size``, forward, crop
        (``image_restoration_model.py:175-186``)."""
        h, w = lq.shape[-2:]
        x = F.pad(lq, (0, (-w) % window_size, 0, (-h) % window_size), mode="reflect")
        return self.test(x, net)[:, :, :h, :w]

    def validation(self, dataloader, current_iter=0, save_img=False,
                   rgb2bgr=True, use_image=True) -> Dict[str, float]:
        """The registry metrics over a val loader (``sr_model.py:121-233``):
        BGR float images in [0, 1]; the metrics take [0, 255] images, rounded
        to integers with ``use_image``."""
        val_opt = self.opt.get("val") or {}
        metric_opts = val_opt.get("metrics") or {}
        window_size = val_opt.get("window_size", 0)
        results = {name: 0.0 for name in metric_opts}
        net = self._eval_net()
        n = 0
        for batch in dataloader:
            lq = to_nchw(batch["lq"], self.device)
            pred = self.pad_test(lq, window_size, net) if window_size else self.test(lq, net)
            pred = pred.permute(0, 2, 3, 1).float().cpu().numpy()
            for b in range(pred.shape[0]):
                sr255 = np.clip(pred[b] * 255.0, 0, 255)
                gt255 = np.clip(batch["gt"][b] * 255.0, 0, 255)
                if use_image:
                    sr255, gt255 = sr255.round(), gt255.round()
                for name, m_opt in metric_opts.items():
                    results[name] += calculate_metric({"img": sr255, "img2": gt255}, m_opt)
                n += 1
        return {k: v / max(n, 1) for k, v in results.items()}

    # -- checkpointing -----------------------------------------------------

    @master_only
    def save(self, epoch: int, current_iter: int) -> None:
        models_dir = self.opt["path"]["models"]
        states_dir = self.opt["path"]["training_states"]
        os.makedirs(models_dir, exist_ok=True)
        os.makedirs(states_dir, exist_ok=True)
        save_params(os.path.join(models_dir, f"net_g_{current_iter}.pth"),
                    self.net_g.state_dict())
        if self.state is None:
            return
        if self.state.ema is not None:
            save_params(os.path.join(models_dir, f"net_g_ema_{current_iter}.pth"),
                        self.state.ema_state_dict())
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
        payload = {
            "epoch": epoch, "iter": current_iter, "step": self.state.step,
            "params": cpu(self.net_g.state_dict()),
            "optimizer": self.state.optimizer.state_dict(),
            "ema": cpu(self.state.ema) if self.state.ema is not None else None,
        }
        _write_with_retry(os.path.join(states_dir, f"{current_iter}.state"),
                          lambda p: torch.save(payload, p))

    def resume_training(self, state_path: str) -> Dict:
        st = torch.load(state_path, map_location="cpu", weights_only=True)
        self.net_g.load_state_dict(st["params"])
        self.state.optimizer.load_state_dict(st["optimizer"])
        if st["ema"] is not None and self.state.ema is not None:
            for k, v in st["ema"].items():
                self.state.ema[k].copy_(v)
        self.state.step = st["step"]
        return {"epoch": st["epoch"], "iter": st["iter"]}


@MODEL_REGISTRY.register()
class MambaIRModel(SRModel):
    """SRModel and the chop-and-stitch tiled test (``mambair_model.py:13-80``),
    through the port's engine."""

    def tile_test(self, lq: np.ndarray, tile: int = 200) -> np.ndarray:
        """Each NHWC image of ``lq`` through ``core.engine.run_model_inference``
        at patch ``tile`` and overlap ``tile // 10``."""
        from tpuir_torch.core.engine import InferenceModel, run_model_inference

        bundle = InferenceModel(name=self.net_type, net=self._eval_net(), device=self.device,
                                patch_size=tile, patch_overlap=tile // 10, pad_factor=8)
        return np.stack([run_model_inference(bundle, img)[0] for img in lq])


@MODEL_REGISTRY.register()
class MaIRPlusModel(MambaIRModel):
    """x8 self-ensemble at test time (``mairplus_model.py:8``): the four
    rotations of H, W, each also flipped along W."""

    @torch.no_grad()
    def test(self, lq: torch.Tensor, net: Optional[torch.nn.Module] = None) -> torch.Tensor:
        net = net or self._eval_net()
        lq = lq.to(self.device)
        acc = None
        for rot in range(4):
            for flip in (False, True):
                x = torch.rot90(lq, rot, dims=(2, 3))
                if flip:
                    x = torch.flip(x, dims=(3,))
                y = net(x.contiguous())
                if flip:
                    y = torch.flip(y, dims=(3,))
                y = torch.rot90(y, -rot, dims=(2, 3))
                acc = y if acc is None else acc + y
        return acc / 8.0


@MODEL_REGISTRY.register()
class ImageCleanModel(SRModel):
    """Restormer's wrapper name (``image_restoration_model.py:51-327``):
    mixup and the window pad_test are SRModel's here."""


def build_model(opt: Dict, device=None):
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device)
