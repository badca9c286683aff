"""Process groups: BasicSR's ``dist_util`` (``init_dist``, ``get_dist_info``,
``master_only``) on ``torch.distributed``, the counterpart of
``tpuir/parallel/dist.py``.

One process per GPU, torchrun's model. ``init_dist`` takes the world from
its arguments, else from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), else from SLURM's
(``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``, the master the first
host of ``SLURM_NODELIST``). A CUDA device is ``cuda:LOCAL_RANK`` unless the
caller names one, and takes NCCL; gloo is used only on the CPU or where the
caller names it (two ranks on one card, which NCCL refuses). There is no
fallback: a CUDA run whose NCCL group does not form raises. With no world
named the process stays alone, with no group, and ``get_dist_info()`` is
``(0, 1)``.
"""

from __future__ import annotations

import datetime
import functools
import os
import subprocess
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from tpuir_torch.utils.misc import resolve_device

TIMEOUT_S = 60.0  # every group's collective limit: a hung peer fails the run
DEFAULT_PORT = 29500  # BasicSR's init_dist_slurm port
_state = {"device": None}  # the device ``init_dist`` bound in this process


class World(NamedTuple):
    """Where this process stands: its rank, the world size, its rank on its
    host, and the URL its group meets at (None: a process alone)."""

    rank: int
    world_size: int
    local_rank: int
    init_method: Optional[str]


def world_from_env(env=None) -> World:
    """The world torchrun or SLURM describe in ``env`` (default
    ``os.environ``): torchrun's variables first, then SLURM's; a process
    alone where neither names a world size."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" in env:
        rank = int(env.get("RANK", 0))
        local = int(env.get("LOCAL_RANK", rank))
        return World(rank, int(env["WORLD_SIZE"]), local, "env://")
    if "SLURM_NTASKS" in env and "SLURM_PROCID" in env:
        rank = int(env["SLURM_PROCID"])
        local = int(env.get("SLURM_LOCALID", rank))
        addr = env.get("MASTER_ADDR") or _slurm_master(env.get("SLURM_NODELIST", ""))
        port = env.get("MASTER_PORT", str(DEFAULT_PORT))
        return World(rank, int(env["SLURM_NTASKS"]), local, f"tcp://{addr}:{port}")
    return World(0, 1, 0, None)


def _slurm_master(nodelist: str) -> str:
    """The first host of a SLURM node list (``scontrol show hostnames``, as
    BasicSR's ``init_dist_slurm``); ``localhost`` for an empty list."""
    if not nodelist:
        return "localhost"
    out = subprocess.run(["scontrol", "show", "hostnames", nodelist], check=True,
                         capture_output=True, text=True).stdout.split()
    return out[0]


def init_dist(backend: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, local_rank: Optional[int] = None,
              init_method: Optional[str] = None,
              device: Union[str, torch.device, None] = None) -> torch.device:
    """Join this process's group and return the device it runs on.

    The world is ``rank``/``world_size`` where given (``init_method`` then
    names the meeting place, e.g. ``file:///tmp/store``), else
    ``world_from_env()``. ``device`` defaults to ``cuda:LOCAL_RANK``
    (``cpu`` where the caller says so); ``backend`` to NCCL for a CUDA
    device and gloo for the CPU. A process alone joins no group. Called
    again in a process whose group exists, it returns the device bound then.
    """
    if dist.is_initialized():
        return bound_device()
    if world_size is None:
        world = world_from_env()
    else:
        rank = 0 if rank is None else rank
        world = World(rank, world_size, rank if local_rank is None else local_rank,
                      init_method or "env://")
    dev = torch.device(device if device is not None else f"cuda:{world.local_rank}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: pass device='cpu' (--device cpu) "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", world.local_rank)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} for local rank {world.local_rank}: this host has "
                               f"{torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {dev}")
    _state["device"] = dev
    if world.world_size == 1 and world.init_method is None:
        return dev  # a process alone: no group
    dist.init_process_group(backend, init_method=world.init_method, rank=world.rank,
                            world_size=world.world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def bound_device(default=None) -> torch.device:
    """The device ``init_dist`` bound in this process; in a group it did not
    make, the current card under NCCL, else the CPU; in a process alone
    that never called it, ``default`` (``utils.misc.resolve_device``'s)."""
    if _state["device"] is not None:
        return _state["device"]
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    return resolve_device(default)


def get_dist_info() -> Tuple[int, int]:
    """(rank, world_size); (0, 1) for a process in no group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def master_only(func):
    """Run ``func`` on rank 0 only; other ranks get None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper


def destroy_dist() -> None:
    """Leave this process's group, if it has one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = None
