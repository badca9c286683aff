"""Small host-side helpers (counterpart of ``tpuir/utils/misc.py``)."""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping, Union

import numpy as np
import torch
from torch import nn


def param_count(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Total number of scalar parameters of a module or a state dict.

    The harness's param-count column, as the original's
    ``get_model_total_parameters`` counts it.
    """
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return int(sum(t.numel() for t in tensors))


def bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), in t's dtype: a serving body's
    product operand, as the JAX kernels' ``astype(bfloat16)`` rounds it."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_padded_rows(w: torch.Tensor) -> torch.Tensor:
    """A float32 weight (rows, cols) as a serving kernel copies it for its
    bf16 products (``csrc/tc_gemm.cuh:round_rows_bf16``): rounded to bf16
    (nearest even) in rows of cols rounded up to 8 values, zeros past cols."""
    return torch.nn.functional.pad(w, (0, -w.shape[-1] % 8)).to(torch.bfloat16)


def seeded_state_dict(net: nn.Module, seed: int = 0, gain=None) -> dict:
    """A full state dict for ``net``'s keys, drawn from RandomState(seed):
    conv weights normal, scaled by ``gain(name)`` (default 1) over
    sqrt(fan_in); biases 0.02 times a normal; norm weights (1-D) 1 plus 0.1
    times a normal; running means normal and running variances in
    [0.5, 1.5), so that a forward that read them would show it; batch
    counts 0. ``net`` may live on the meta device."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros(shape, dtype=torch.long)
            continue
        if name.endswith("running_mean"):
            a = rng.standard_normal(shape)
        elif name.endswith("running_var"):
            a = 0.5 + rng.rand(*shape)
        elif name.endswith("bias"):
            a = 0.02 * rng.standard_normal(shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) * ((gain(name) if gain else 1.0) / np.sqrt(fan_in))
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))
    return sd


def float32_pinned(x: torch.Tensor) -> bool:
    """Whether convs on ``x`` run in true float32 on the card: a CUDA tensor
    while TF32 is off for cuDNN (the engine's parity pin,
    ``core.engine.true_float32``)."""
    return x.is_cuda and not torch.backends.cudnn.allow_tf32


@contextlib.contextmanager
def without_cudnn() -> Iterator[None]:
    """Run convs on PyTorch's own CUDA convolutions (im2col and cuBLAS)
    instead of cuDNN; restore the setting on exit. Only ``enabled`` is
    touched: ``torch.backends.cudnn.flags`` would reset TF32 too."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``cuda``) as a torch.device; ``cuda`` is card 0
    and raises where torch finds no card."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: pass device='cpu' (--device cpu) "
                               "to train or test on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
