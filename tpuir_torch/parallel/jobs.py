"""What a rank runs under ``launch``: sharded serving, data-parallel train
steps and the training script, each returning what the caller checks as
NumPy arrays and numbers (and the rank's kernel launches).

They live here, in a module of the port, because ``spawn`` pickles a
rank's function by its import path: each rank imports this module and
nothing of the caller. Each also runs in a process in no group (the
single-device twin): the mesh is then one rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpuir_torch.core.engine import InferenceModel
from tpuir_torch.ops import _kernels
from tpuir_torch.parallel.dist import bound_device, get_dist_info
from tpuir_torch.parallel.inference import run_model_inference_sharded
from tpuir_torch.parallel.mesh import batch_sharding, make_mesh

# a request: (HWC image, AWGN sigma or None)
Request = Tuple[np.ndarray, Optional[float]]


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory (a CPU tensor's ``numpy()`` is a view)."""
    return t.detach().to("cpu", copy=True).numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def on_device(model: Union[InferenceModel, Callable], device: torch.device) -> InferenceModel:
    """``model`` moved to ``device``, or, for a callable, ``model(device=device)``
    (e.g. a ``functools.partial`` of ``zoo.get_model_instance``)."""
    if isinstance(model, InferenceModel):
        return dataclasses.replace(model, net=model.net.to(device), device=device)
    return model(device=device)


def serve(models: Sequence, requests: Sequence[Sequence[Request]], rounds: int = 1) -> Dict:
    """Serve ``requests[i]`` with ``models[i]`` through
    ``run_model_inference_sharded`` on this rank's device, ``rounds`` times.
    Returns {"outputs": [[image of each request] of each model] (the last
    round's), "ms": the same shape, the median over rounds, "launches":
    {kernel: launches over every round}}."""
    device = bound_device()
    mesh = make_mesh()
    outputs, ms = [], []
    _kernels.reset_launches()
    for model, reqs in zip(models, requests):
        model = on_device(model, device)
        outs, times = [], []
        for img, sigma in reqs:
            rounds_ms = []
            for _ in range(rounds):
                out, t = run_model_inference_sharded(model, img, mesh,
                                                     need_degradation=sigma is not None,
                                                     noise_level=sigma)
                rounds_ms.append(t)
            outs.append(out)
            times.append(float(np.median(rounds_ms)))
        outputs.append(outs)
        ms.append(times)
    return {"outputs": outputs, "ms": ms, "launches": dict(_kernels.LAUNCHES)}


def time_gathers(shape: Sequence[int], gathers: Sequence[str] = ("host", "device"),
                 iters: int = 10) -> Dict[str, float]:
    """Median ms of ``gather_patches`` by route, for a share of ``shape``
    (a rank's predictions) on this rank's device."""
    from tpuir_torch.parallel.inference import gather_patches

    device = bound_device()
    mesh = make_mesh()
    local = np.random.RandomState(get_dist_info()[0]).rand(*shape).astype(np.float32)
    out = {}
    for route in gathers:
        times = []
        for _ in range(iters + 1):
            if mesh.host_group is not None:
                torch.distributed.barrier(group=mesh.host_group)
            t0 = time.perf_counter()
            got = gather_patches(local, mesh, route, device)
            times.append((time.perf_counter() - t0) * 1000.0)
        if not np.array_equal(got[mesh.rank * shape[0]:(mesh.rank + 1) * shape[0]], local):
            raise RuntimeError(f"gather {route!r} lost this rank's share")
        out[route] = float(np.median(times[1:]))
    return out


def train_steps(opt: Dict, lq: np.ndarray, gt: np.ndarray, keep_grads: int = 1) -> Dict:
    """``len(lq)`` train steps of ``train.model.build_model(opt)`` through
    its ``optimize_parameters``: step i on the batch ``lq[i]``, ``gt[i]``
    (NHWC, the global batch), each rank on its contiguous share
    (``batch_sharding``), under DDP where this process is in a group (a
    group of one too). Returns per step the loss (over the global batch),
    the ms (host clock, the device synchronised), and after each step the
    weights and EMA; the gradients (as the optimizer took them, clipped) of the first
    ``keep_grads`` steps; and the launches."""
    from tpuir_torch.train.model import build_model

    device = bound_device(opt.get("device"))
    rank, world = get_dist_info()
    opt = dict(opt, device=str(device), dist=torch.distributed.is_initialized(), rank=rank,
               world_size=world)
    model = build_model(opt)
    mesh = make_mesh()
    out: Dict[str, List] = {"loss": [], "ms": [], "params": [], "ema": [], "grads": []}
    _kernels.reset_launches()
    for i in range(len(lq)):
        share = batch_sharding(mesh, lq[i].shape[0])
        _sync(device)
        t0 = time.perf_counter()
        log = model.optimize_parameters({"lq": lq[i][share], "gt": gt[i][share]})
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1000.0)
        out["loss"].append(log["l_pix"])
        net = model.net_g
        out["params"].append({k: _host(p) for k, p in net.named_parameters()})
        if model.state.ema is not None:
            out["ema"].append({k: _host(v) for k, v in model.state.ema.items()})
        if i < keep_grads:
            out["grads"].append({k: _host(p.grad) for k, p in net.named_parameters()
                                 if p.grad is not None})
    out["launches"] = dict(_kernels.LAUNCHES)
    return out


def train_script(argv: Sequence[str], root: str) -> Dict:
    """``tpuir_torch/scripts/train.py``'s ``main(argv, root)`` on this rank;
    returns its rank, iteration and final weights."""
    from tpuir_torch.scripts import train

    result = train.main(list(argv), root_path=root)
    net = result["model"].net_g
    return {"rank": get_dist_info()[0], "iter": result["iter"],
            "params": {k: _host(p) for k, p in net.named_parameters()}}


def wait_for(path: str, timeout: float) -> float:
    """Wait until ``path`` exists (a caller's signal that its own card work
    is done, so that a world can start beside it and run after it); the
    seconds waited. Raises ``TimeoutError`` past ``timeout``."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout:.0f} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def several(calls: Sequence[Tuple[Callable, Sequence]]) -> List:
    """Each ``(fn, args)`` of ``calls`` in turn on this rank (one world for
    several jobs); their results in order."""
    return [fn(*args) for fn, args in calls]
