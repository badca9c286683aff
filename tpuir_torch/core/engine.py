"""Batched overlap-tiled inference engine (PyTorch port of ``tpuir/core/engine.py``).

The behavioural contract is the JAX engine's:

  normalize -> KAIR tile grid -> (optional seeded AWGN, the same field on
  every patch) -> pad-to-multiple + crop-back -> model forward ->
  (optional postprocess) -> Gaussian-window weighted accumulate -> divide
  by the weight map -> restore the input dtype.

Host steps are this package's copies of the JAX engine's: the patch
gather and blend-stitch are ``core/native.py`` (the same C loops as
``tpuir.native``, bit-exact float32), and the AWGN, window and dtype
restore are NumPy copies. Patches go to the device in
``batch_size`` chunks; a ragged last chunk runs as it is, since eager
PyTorch has no compile cache to bound. As in the JAX engine, up to
``max_in_flight`` chunks are enqueued and not yet fetched, so the card
computes one chunk while the host stages and launches the next: on a CUDA
device each chunk of a request of two or more is staged through a ring of
pinned host buffers and copied both ways with ``non_blocking``, on the
stream that runs the forward (a separate copy stream bought nothing at
these transfer sizes, and pinned staging made one-chunk requests slower:
``PERF.md``).
The blend window is built on the crop that the tiles use
(``window_crop``), not at the full patch size.

Parity mode (``compute_dtype=None``) pins true float32: TF32 is off for
cuBLAS and cuDNN while a chunk runs (cuDNN allows TF32 by default), the
counterpart of ``jax.default_matmul_precision("float32")`` in the JAX
engine. A ``compute_dtype`` (the serving modes) skips the pin, leaving
PyTorch's own TF32 defaults, the counterpart of XLA's default precision;
``"bfloat16"`` also casts the chunk to bf16 before the forward. The output
is widened to float32 in every mode. DeblurGANv2's phase-layout I/O is a
TPU layout and has no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import native
from .degrade import add_noise_batched
from .image_io import normalize_image, restore_dtype
from .tiling import tile_indices
from ..utils.profiling import maybe_trace


def pad_to_multiple(x: torch.Tensor, factor: int, mode: str = "reflect") -> torch.Tensor:
    """Pad NCHW bottom/right so H and W are multiples of ``factor``.

    mode='reflect' matches the Restormer/MaIR helper; no-op when already
    divisible.
    """
    h, w = x.shape[-2:]
    ph, pw = (-h) % factor, (-w) % factor
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, pw, 0, ph), mode=mode)


def pad_always_block(x: torch.Tensor, block: int = 32) -> torch.Tensor:
    """DeblurGANv2's zero pad to the next multiple of ``block`` (always at
    least one block, even when divisible)."""
    h, w = x.shape[-2:]
    ph = (h // block + 1) * block - h
    pw = (w // block + 1) * block - w
    return F.pad(x, (0, pw, 0, ph), mode="constant")


@contextlib.contextmanager
def true_float32() -> Iterator[None]:
    """Turn TF32 off for cuBLAS and cuDNN; restore the settings on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass
class InferenceModel:
    """A model plus its engine hooks, as handed to the tiled engine.

    ``net`` maps an NCHW float32 batch on ``device`` to NCHW. The hooks are
    the JAX engine's: ``normalize`` (host, HWC -> float32), ``pad_factor``
    (reflect pad-to-multiple; Restormer and MaIR: 8), ``pad_block``
    (DeblurGANv2's always-pad), ``postprocess`` (on the device output),
    ``compute_dtype`` (None: parity, true float32; "float32": no TF32 pin;
    "bfloat16": no pin, the chunk cast to bf16).
    """

    name: str
    net: nn.Module
    device: torch.device
    patch_size: Optional[int] = None
    patch_overlap: int = 32
    pad_factor: Optional[int] = None
    pad_block: Optional[int] = None
    normalize: Callable[[np.ndarray], np.ndarray] = staticmethod(normalize_image)
    postprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    batch_size: int = 8
    param_count: int = 0
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r} "
                             "(None|'float32'|'bfloat16')")

    @torch.inference_mode()
    def step(self, x: torch.Tensor) -> torch.Tensor:
        """cast -> pad -> forward -> crop -> postprocess, for one chunk (n, C, h, w)."""
        h, w = x.shape[-2:]
        if self.compute_dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        if self.pad_factor:
            x = pad_to_multiple(x, self.pad_factor, mode="reflect")
        elif self.pad_block:
            x = pad_always_block(x, self.pad_block)
        with true_float32() if self.compute_dtype is None else contextlib.nullcontext():
            y = self.net(x)
        y = y[:, :, :h, :w]
        if self.postprocess is not None:
            y = self.postprocess(y)
        return y.float()

    def forward_patches(
        self,
        patches: np.ndarray,
        progress_cb: Optional[Callable[[int, int], None]] = None,
        max_in_flight: int = 4,
    ) -> np.ndarray:
        """Run (N, h, w, C) float32 patches through ``step`` in ``batch_size`` chunks.

        Chunks are enqueued ahead of the fetches with a bounded window:
        the oldest chunk is fetched only when ``max_in_flight`` are
        un-fetched, and the rest at the end. On a CUDA device, where there
        are two chunks or more, a chunk is
        copied into the next of ``max_in_flight`` pinned staging buffers
        (once that buffer's previous host-to-device copy has finished),
        sent with ``non_blocking``, and its output copied back
        ``non_blocking`` into a pinned output array, an event recorded
        after it; fetching waits on that event. Every copy and launch goes
        to the current stream, so the caching allocator's stream order
        keeps each chunk's device tensors until their copies are done. A
        single chunk, which the window cannot overlap with anything, is
        copied both ways from and into pageable memory with blocking
        copies. On the CPU nothing is pinned and each step has finished
        when it returns. An NHWC chunk permuted to NCHW is already
        ``channels_last`` with no copy. ``progress_cb`` reports fetched
        patches.
        """
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be at least 1, got {max_in_flight}")
        n = patches.shape[0]
        bs = max(1, min(self.batch_size, n))
        chunks = -(-n // bs)
        pinned = torch.device(self.device).type == "cuda" and chunks > 1
        if pinned:
            stream = torch.cuda.current_stream(self.device)
            ring = [torch.empty((bs,) + patches.shape[1:], dtype=torch.float32, pin_memory=True)
                    for _ in range(min(max_in_flight, chunks))]
            staged = [None] * len(ring)  # each buffer's last host-to-device copy
        out = None
        pending = collections.deque()  # (patches done once fetched, event or None)

        def fetch_one():
            done, event = pending.popleft()
            if event is not None:
                event.synchronize()
            if progress_cb is not None:
                progress_cb(done, n)

        for i, off in enumerate(range(0, n, bs)):
            sz = min(bs, n - off)
            if pinned:
                slot = i % len(ring)
                if staged[slot] is not None:
                    staged[slot].synchronize()
                host = ring[slot][:sz]
                host.copy_(torch.from_numpy(patches[off : off + sz]))
                chunk = host.to(self.device, non_blocking=True)
                staged[slot] = torch.cuda.Event()
                staged[slot].record(stream)
            else:
                chunk = torch.from_numpy(patches[off : off + sz]).to(self.device)
            y = self.step(chunk.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            if out is None:
                out = torch.empty((n,) + y.shape[1:], dtype=torch.float32, pin_memory=pinned)
            out[off : off + sz].copy_(y, non_blocking=pinned)
            event = None
            if pinned:
                event = torch.cuda.Event()
                event.record(stream)
            pending.append((off + sz, event))
            while len(pending) >= max_in_flight:
                fetch_one()
        while pending:
            fetch_one()
        return out.numpy()


@functools.lru_cache(maxsize=16)
def window_crop(ps: int, ph: int, pw: int, n_channels: int) -> np.ndarray:
    """``tiling.gaussian_window(ps, ps, n_channels)[:ph, :pw]``, bit for bit,
    evaluated on the (ph, pw) crop only: the same float64 expression with
    the centre and sigma of the full ``ps`` (the 2-D exponential, since the
    exponential of a sum is not separable bit for bit). Cached; the arrays
    are read-only."""
    yy, xx = np.meshgrid(np.arange(ph, dtype=np.float64), np.arange(pw, dtype=np.float64),
                         indexing="ij")
    c, s = ps / 2.0, ps * 0.125
    g = np.exp(-((yy - c) ** 2 / (2.0 * s**2) + (xx - c) ** 2 / (2.0 * s**2)))
    g = np.repeat(g[:, :, None], n_channels, axis=2).astype(np.float32)
    g.flags.writeable = False
    return g


def run_model_inference(
    model: InferenceModel,
    input_img: np.ndarray,
    patch_size: Optional[int] = None,
    patch_overlap: Optional[int] = None,
    need_degradation: bool = False,
    noise_level: Optional[float] = None,
    progress_cb: Optional[Callable[[int, int], None]] = None,
    max_in_flight: int = 4,
):
    """Tiled inference over one image. Returns (restored_image, time_ms).

    ``input_img`` is HWC uint8/uint16/float; the output has the same dtype.
    ``max_in_flight`` is ``InferenceModel.forward_patches``'.
    """
    start_time = time.time()

    patch_size = model.patch_size if patch_size is None else patch_size
    patch_overlap = model.patch_overlap if patch_overlap is None else patch_overlap

    img = np.ascontiguousarray(model.normalize(input_img))
    h, w = img.shape[:2]
    out_ch = min(3, img.shape[2])

    ps, h_idx_list, w_idx_list = tile_indices(h, w, patch_size, patch_overlap)
    ph, pw = min(ps, h), min(ps, w)
    coords = [(hi, wi) for hi in h_idx_list for wi in w_idx_list]

    patches = native.extract_patches(img, coords, ph, pw)
    if need_degradation and noise_level is not None:
        # bit-exact float64 AWGN add (the original's arithmetic), once per batch
        patches = add_noise_batched(patches, noise_level)

    with maybe_trace(f"engine_{model.name.replace(' ', '_')}"):
        preds = model.forward_patches(patches, progress_cb, max_in_flight)

    window = window_crop(ps, ph, pw, out_ch)
    output_img = native.blend_stitch(preds[:, :, :, :out_ch], coords, window, h, w)
    output_img = restore_dtype(output_img, input_img)
    return output_img, (time.time() - start_time) * 1000.0
