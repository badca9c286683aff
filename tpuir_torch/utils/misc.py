"""Small host-side helpers (counterpart of ``tpuir/utils/misc.py``)."""

from __future__ import annotations

from typing import Mapping, Union

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
