"""Training core: the train state, the optimizer and the train step.

The counterpart of ``tpuir/train/trainer.py`` (BasicSR's ``base_model.py``
and ``sr_model.py`` training machinery). tpuir's ``TrainState`` (step,
params, optimizer state, EMA params) becomes ``TrainState`` here: the
network, its ``torch.optim`` optimizer, the step count and an EMA copy of
the parameters. The step is tpuir's: the loss, its backward, the gradient
clip (BasicSR's ``use_grad_clip``: scale ``min(1, clip / (|g| + 1e-6))``
with clip 0.01, which is ``torch.nn.utils.clip_grad_norm_``'s), the
optimizer step at ``schedule(step)`` and the EMA update
``e * decay + p * (1 - decay)``. Adam and AdamW keep optax's betas, eps
(1e-8) and decoupled weight decay. Forward and backward run with TF32 off,
as the engine's float32 path does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from tpuir_torch.core.engine import true_float32


def build_optimizer(opt: dict, params) -> torch.optim.Optimizer:
    """BasicSR ``optim_g`` dict -> Adam or AdamW (optax's eps and betas; the
    lr is set from the schedule before every step)."""
    opt = dict(opt)
    kind = opt.pop("type", "Adam")
    betas = tuple(opt.pop("betas", (0.9, 0.999)))
    weight_decay = opt.pop("weight_decay", 0.0)
    lr = opt.pop("lr", 2e-4)
    if kind == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=weight_decay)
    if kind == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    raise NotImplementedError(kind)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


class TrainState:
    """The network, its optimizer, the lr schedule, the step count (the
    optimizer steps taken) and, with ``ema_decay``, an EMA copy of the
    parameters ({name: tensor}). ``forward_net`` (default ``net``) runs the
    training forward: under data parallelism, ``net`` wrapped in
    ``DistributedDataParallel``, whose backward averages the gradients over
    the ranks. The bare ``net`` keeps the state dict, the EMA and the
    checkpoints."""

    def __init__(self, net: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], ema_decay: Optional[float] = None,
                 forward_net: Optional[torch.nn.Module] = None):
        self.net = net
        self.forward_net = net if forward_net is None else forward_net
        self.optimizer = optimizer
        self.schedule = schedule
        self.ema_decay = ema_decay or None
        self.step = 0
        self.ema = ({k: p.detach().clone() for k, p in net.named_parameters()}
                    if self.ema_decay else None)

    def parameters(self):
        return [p for p in self.net.parameters() if p.requires_grad]

    def forward_loss(self, lq: torch.Tensor, gt: torch.Tensor, loss_fn) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        with true_float32():
            return loss_fn(self.forward_net(lq), gt)

    def backward(self, loss: torch.Tensor) -> None:
        with true_float32():
            loss.backward()

    @torch.no_grad()
    def apply_gradients(self, grad_clip: Optional[float] = None,
                        norm: Optional[Callable] = None) -> torch.Tensor:
        """Clip, step the optimizer at ``schedule(step)``, update the EMA;
        returns the gradient's global norm before the clip. ``norm(params)``
        gives that norm where this process holds only part of the gradient
        (a mesh's ``tp`` shards: ``parallel/train.py``)."""
        params = [p for p in self.parameters() if p.grad is not None]
        if norm is not None:
            gnorm = norm(params)
            if grad_clip:
                torch.nn.utils.clip_grads_with_norm_(params, grad_clip, gnorm)
        elif grad_clip:
            gnorm = torch.nn.utils.clip_grad_norm_(params, grad_clip)
        else:
            gnorm = global_norm([p.grad for p in params])
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        if self.ema is not None:
            d = self.ema_decay
            for k, p in self.net.named_parameters():
                self.ema[k].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
        return gnorm

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The network's state dict with the EMA copy in place of its parameters."""
        sd = self.net.state_dict()
        sd.update(self.ema)
        return sd


def train_step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, loss_fn,
               grad_clip: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One step: {loss, grad_norm}, both detached tensors on the device."""
    loss = state.forward_loss(lq, gt, loss_fn)
    state.backward(loss)
    gnorm = state.apply_gradients(grad_clip)
    return {"loss": loss.detach(), "grad_norm": gnorm}
