"""Tiled inference with the patch grid split over the ranks of a mesh, the
counterpart of ``tpuir/parallel/inference.py``.

Every rank takes the same image and cuts the same tile grid
(``core/native.extract_patches``), adds the host AWGN to every patch before
the split (so each patch keeps the seed-0 field the engine gives it), pads
the patch batch to a multiple of the mesh's ``dp`` axis by repeating the
last patch, and runs its ``dp`` coordinate's contiguous share through
``InferenceModel.forward_patches`` (the model's precision mode and
in-flight window), as tpuir splits the grid over ``mesh.shape["dp"]``:
ranks that differ only in ``sp`` or ``tp`` hold the same share. The
predictions are gathered on every rank, which blends the whole image on
the host with the engine's window and returns it in the input's dtype. The
forward path has no collective but that gather.

The gather moves host arrays, since the blend is on the host: it
all-gathers CPU tensors over the mesh's gloo group along ``dp``, which
holds one rank of each share. ``gather_patches`` also has the other route,
for its measurement: the share copied to the device, all-gathered there on
the group along ``dp`` (NCCL where it is one) and copied back once, which
cost as much or more on the H100 in worlds of one and two (``PERF.md``,
§6, data parallelism).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuir_torch.core import native
from tpuir_torch.core.degrade import add_noise_batched
from tpuir_torch.core.engine import InferenceModel, window_crop
from tpuir_torch.core.image_io import restore_dtype
from tpuir_torch.core.tiling import tile_indices
from tpuir_torch.parallel.mesh import Mesh, batch_sharding
from tpuir_torch.utils.profiling import maybe_trace

GATHERS = ("host", "device")
# all_gather_into_tensor, under its newer name where this torch has it
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather_patches(local: np.ndarray, mesh: Mesh, gather: str = "host",
                   device=None) -> np.ndarray:
    """Every ``dp`` coordinate's ``local`` (each the same shape), in ``dp``
    order, on every rank, gathered along ``dp``. ``gather`` is ``"host"`` or
    ``"device"`` (on ``device``); with a ``dp`` of one, or in no group, it
    returns ``local``."""
    if gather not in GATHERS:
        raise ValueError(f"unknown gather {gather!r} ({'|'.join(GATHERS)})")
    if mesh.host_group is None:
        return local
    shape = (mesh.shape("dp") * local.shape[0],) + local.shape[1:]
    if gather == "host":
        out = torch.empty(shape, dtype=torch.from_numpy(local[:0]).dtype)
        _all_gather_into(out, torch.from_numpy(np.ascontiguousarray(local)),
                         group=mesh.host_group)
        return out.numpy()
    share = torch.from_numpy(np.ascontiguousarray(local)).to(device)
    full = torch.empty(shape, dtype=share.dtype, device=share.device)
    _all_gather_into(full, share, group=mesh.group("dp"))
    return full.cpu().numpy()


def dp_share(mesh: Mesh, n: int):
    """(the patches a batch of ``n`` is padded with, this rank's slice of the
    padded batch): the batch split over ``dp`` alone."""
    n_pad = (-n) % mesh.shape("dp")
    return n_pad, batch_sharding(mesh, n + n_pad)


def run_model_inference_sharded(
    model: InferenceModel,
    input_img: np.ndarray,
    mesh: Mesh,
    patch_size: Optional[int] = None,
    patch_overlap: Optional[int] = None,
    need_degradation: bool = False,
    noise_level: Optional[float] = None,
    max_in_flight: int = 4,
):
    """Tiled inference of one image with the patch batch split over
    ``mesh``'s ``dp`` axis. Returns (restored_image, time_ms), as
    ``core.engine.run_model_inference``; every rank returns the whole image."""
    start = time.time()
    patch_size = model.patch_size if patch_size is None else patch_size
    patch_overlap = model.patch_overlap if patch_overlap is None else patch_overlap

    img = np.ascontiguousarray(model.normalize(input_img))
    h, w = img.shape[:2]
    out_ch = min(3, img.shape[2])
    ps, h_idx, w_idx = tile_indices(h, w, patch_size, patch_overlap)
    ph, pw = min(ps, h), min(ps, w)
    coords = [(hi, wi) for hi in h_idx for wi in w_idx]

    patches = native.extract_patches(img, coords, ph, pw)
    if need_degradation and noise_level is not None:
        patches = add_noise_batched(patches, noise_level)
    n = patches.shape[0]
    n_pad, share = dp_share(mesh, n)
    if n_pad:
        patches = np.concatenate([patches, np.repeat(patches[-1:], n_pad, axis=0)])

    mine = np.ascontiguousarray(patches[share])
    with maybe_trace(f"engine_sharded_{model.name.replace(' ', '_')}"):
        local = model.forward_patches(mine, max_in_flight=max_in_flight)
    preds = gather_patches(local, mesh)[:n]

    window = window_crop(ps, ph, pw, out_ch)
    out = native.blend_stitch(preds[:, :, :, :out_ch], coords, window, h, w)
    return restore_dtype(out, input_img), (time.time() - start) * 1000.0
