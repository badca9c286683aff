"""Learning-rate schedules: ``tpuir/train/schedulers.py``'s step -> lr functions.

BasicSR's MultiStepRestartLR and CosineAnnealingRestartLR
(``basicsr/models/lr_scheduler.py:6-120``), the Restormer configs'
CosineAnnealingRestartCyclicLR (e.g.
``options/train/GaussianColorDenoising_RestormerSigma25.yml``) and
TrueCosineAnnealingLR, as plain Python functions of the step. The trainer
sets the optimizer's lr to ``schedule(step)`` before each optimizer step,
where ``step`` counts the steps taken before it: optax reads its count
before incrementing it, so the lr of the port's step i is tpuir's
``schedule(i)``.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1,)) -> Schedule:
    ms = sorted(milestones)
    rs, rw = list(restarts), list(restart_weights)

    def schedule(step: int) -> float:
        if step in rs:
            return base_lr * rw[rs.index(step)]
        return base_lr * gamma ** bisect.bisect_right(ms, step)

    return schedule


def _cosine_restart(base_lr, periods, restart_weights, eta_mins) -> Schedule:
    cum = [sum(periods[: i + 1]) for i in range(len(periods))]

    def schedule(step: int) -> float:
        # the first period i with step <= cum[i] (lr_scheduler.py
        # get_position_from_periods), clamped to the last
        idx = min(bisect.bisect_left(cum, step), len(periods) - 1)
        nearest_restart = 0 if idx == 0 else cum[idx - 1]
        frac = (step - nearest_restart) / periods[idx]
        return eta_mins[idx] + restart_weights[idx] * 0.5 * (base_lr - eta_mins[idx]) * (
            1 + math.cos(math.pi * frac))

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,),
                                eta_min: float = 0.0) -> Schedule:
    """Cosine annealing to one eta_min with per-period restart weights."""
    return _cosine_restart(base_lr, list(periods), list(restart_weights),
                           [eta_min] * len(periods))


def cosine_annealing_restart_cyclic_lr(base_lr: float, periods: Sequence[int],
                                       restart_weights: Sequence[float] = (1,),
                                       eta_mins: Sequence[float] = (0.0,)) -> Schedule:
    """Per-period eta_min variant (the Restormer configs' scheduler)."""
    return _cosine_restart(base_lr, list(periods), list(restart_weights), list(eta_mins))


def true_cosine_annealing_lr(base_lr: float, T_max: int, eta_min: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        s = min(step, T_max)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * s / T_max)) / 2

    return schedule


def build_scheduler(base_lr: float, opt: dict) -> Schedule:
    opt = dict(opt)
    kind = opt.pop("type")
    if kind in ("MultiStepLR", "MultiStepRestartLR"):
        return multi_step_restart_lr(base_lr, **opt)
    if kind == "CosineAnnealingRestartLR":
        return cosine_annealing_restart_lr(base_lr, **opt)
    if kind == "CosineAnnealingRestartCyclicLR":
        return cosine_annealing_restart_cyclic_lr(base_lr, **opt)
    if kind == "TrueCosineAnnealingLR":
        return true_cosine_annealing_lr(base_lr, opt["T_max"], opt.get("eta_min", 0))
    raise NotImplementedError(kind)
