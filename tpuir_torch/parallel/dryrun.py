"""tpuir's ``dryrun_multichip`` (``__graft_entry__.py``) on the port: one
mesh of ``dp``, ``sp`` and ``tp`` ranks, and on it, in tpuir's order,

1. a Restormer train step with its wide parameters over ``tp``
   (``shard_params_tp(..., min_dim=64)``), the batch over ``dp`` and the
   rows over ``sp``;
2. a MaIR and a MaIRUNet train step, the parameters replicated (their
   mixers run K6, K2 and K7 on the rows gathered over ``sp``);
3. K2 (``nss_scan``) on this ``dp`` rank's share of a batch, gathered over
   ``dp``: the caller holds it to one process's call on the whole batch;
4. sharded tiled inference (``run_model_inference_sharded``) on the mesh.

``dryrun_multichip`` is what each rank runs under ``parallel.launch`` (and,
on axes of one in a process alone, the single-process reference). Each
part returns what the caller checks, as NumPy arrays and numbers: a train
part its losses, the gradients as the optimizer took them (averaged,
clipped), the weights and EMA after each step (all of them whole, on the
mesh's rank 0; on every rank a digest of them), its ms and collectives
(``collectives.STATS``) by step and its launches; every part its ms and
collectives, the gathers of what it returns included.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpuir_torch.ops import _kernels
from tpuir_torch.parallel import collectives
from tpuir_torch.parallel.dist import bound_device
from tpuir_torch.parallel.inference import gather_patches
from tpuir_torch.parallel.jobs import _host, _sync, serve
from tpuir_torch.parallel.mesh import Mesh, batch_sharding, make_mesh
from tpuir_torch.parallel.tensor import full_tensors
from tpuir_torch.parallel.train import mesh_train_step, parallelize

# tpuir's dryrun_multichip step: AdamW, its schedule, the 0.01 clip, EMA 0.999
OPTIM = {"type": "AdamW", "lr": 3e-4, "betas": [0.9, 0.999], "weight_decay": 1e-4}
SCHEDULE = {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 20],
            "restart_weights": [1, 1], "eta_mins": [3e-4, 1e-6]}
EMA_DECAY, GRAD_CLIP = 0.999, 0.01


def mesh_axes(n: int) -> Dict[str, int]:
    """Factorize n devices into (dp, sp, tp), favoring dp (tpuir's ``_mesh_axes``)."""
    def split2(m):
        for f in (2, 3, 5, 7):
            if m % f == 0:
                return f
        return 1

    tp = split2(n) if n >= 8 else 1
    rem = n // tp
    sp = split2(rem) if rem >= 4 else 1
    dp = rem // sp
    return {"dp": dp, "sp": sp, "tp": tp}


def _digest(tensors: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha1()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(np.ascontiguousarray(tensors[name]).tobytes())
    return h.hexdigest()


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)


def train_part(mesh: Mesh, network_g: Dict, seed: int, lq: np.ndarray, gt: np.ndarray,
               min_dim: Optional[int] = None) -> Dict:
    """``len(lq)`` steps of the ``network_g`` model (seeded weights, on this
    rank's device), step i on the global NHWC batch ``lq[i]``, ``gt[i]``,
    this rank on its share (see the module docstring)."""
    from tpuir_torch.train.archs import build_network, init_state_dict
    from tpuir_torch.train.losses import l1_loss
    from tpuir_torch.train.schedulers import build_scheduler
    from tpuir_torch.train.trainer import TrainState, build_optimizer

    device = bound_device()
    net = build_network(network_g)
    net.load_state_dict(init_state_dict(network_g, seed))
    net = parallelize(net.to(device), mesh, min_dim)
    optim = build_optimizer(OPTIM, [p for p in net.parameters() if p.requires_grad])
    state = TrainState(net, optim, build_scheduler(OPTIM["lr"], SCHEDULE), EMA_DECAY)
    keep = mesh.rank == 0
    out: Dict[str, List] = {"loss": [], "ms": [], "grads": [], "params": [], "ema": [],
                            "digests": [], "collectives": []}
    _kernels.reset_launches()
    for i in range(len(lq)):
        share = batch_sharding(mesh, lq[i].shape[0], lq[i].shape[1])
        x, y = _nchw(lq[i][share], device), _nchw(gt[i][share], device)
        _sync(device)
        before = {k: dict(v) for k, v in collectives.STATS.items()}
        t0 = time.perf_counter()
        log = mesh_train_step(state, mesh, x, y, l1_loss, GRAD_CLIP)
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1000.0)
        out["collectives"].append({k: {c: v - before[k].get(c, 0) for c, v in d.items()}
                                   for k, d in collectives.STATS.items()})
        out["loss"].append(float(log["loss"]))
        named = dict(net.named_parameters())
        whole = {what: {k: _host(v) for k, v in full_tensors(net, mesh, tensors).items()}
                 for what, tensors in (
                     ("grads", {k: p.grad for k, p in named.items() if p.grad is not None}),
                     ("params", named), ("ema", state.ema))}
        out["digests"].append({what: _digest(t) for what, t in whole.items()})
        for what, t in whole.items():
            out[what].append(t if keep else None)
    out["launches"] = dict(_kernels.LAUNCHES)
    return out


def scan_part(mesh: Mesh, shape: Sequence[int], seed: int) -> Dict:
    """K2's parity body on this ``dp`` rank's share of a seeded batch of
    ``shape`` (B, H, W, d_inner, d_state, dt_rank), shift off, scan_len 4:
    {"y", "pooled"} of the whole batch, gathered over ``dp``, and the launches."""
    from tpuir_torch.ops.nss_stripe import nss_scan

    device = bound_device()
    B, H, W, d, n, r = shape
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, d).astype(np.float32)
    w = [rng.randn(4, r + 2 * n, d) * 0.2, rng.randn(4, d, r) * 0.2,
         -np.exp(rng.randn(4, d, n) * 0.1), rng.rand(4, d), rng.randn(4, d) * 0.1]
    w = [torch.from_numpy(a.astype(np.float32)).to(device) for a in w]
    _kernels.reset_launches()
    with torch.no_grad():
        y, pooled = nss_scan(torch.from_numpy(x[batch_sharding(mesh, B)]).to(device),
                             *w, 4, False)
    _sync(device)
    return {"y": gather_patches(_host(y), mesh), "pooled": gather_patches(_host(pooled), mesh),
            "launches": dict(_kernels.LAUNCHES)}


def dryrun_multichip(axes: Dict[str, int], trains: Sequence[Dict], scan: Optional[Dict] = None,
                     serving: Optional[Sequence] = None) -> Dict:
    """What each rank runs: the mesh ``axes``, then each of ``trains``
    (``train_part``'s keyword arguments), ``scan`` (``scan_part``'s) and
    ``serving`` (``jobs.serve``'s models and requests), in that order.
    Returns {"train": [...], "scan": ..., "serve": ..., "ms": {part: ms},
    "collectives": {part: collectives.STATS}, "peak_bytes": {part: the
    card's peak allocation, None on the CPU}}."""
    mesh = make_mesh(axes)
    out = {"train": [], "ms": {}, "collectives": {}, "peak_bytes": {}}
    cuda = bound_device().type == "cuda"

    def part(name, fn, *args, **kw):
        collectives.reset_stats()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        out["ms"][name] = (time.perf_counter() - t0) * 1000.0
        out["peak_bytes"][name] = torch.cuda.max_memory_allocated() if cuda else None
        out["collectives"][name] = {k: dict(v) for k, v in collectives.STATS.items()}
        if cuda:
            torch.cuda.empty_cache()  # ranks that share a card leave it each other's memory
        return result

    for i, spec in enumerate(trains):
        out["train"].append(part(f"train {i}", train_part, mesh, **spec))
    if scan is not None:
        out["scan"] = part("scan", scan_part, mesh, **scan)
    if serving is not None:
        out["serve"] = part("serve", serve, *serving, mesh=mesh)
    return out
