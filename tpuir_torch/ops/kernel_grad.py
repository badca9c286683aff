"""Gradients through the hand-written kernels, as tpuir's ``custom_vjp`` rules take them.

tpuir trains MaIR through its Pallas kernels without a backward kernel:
each rule (``tpuir/ops/nss_prologue.py:_prologue_vjp``,
``nss_stripe.py:_stripe_vjp``, ``nss_epilogue.py:_epilogue_vjp``,
``nss_fused.py:_nss_vjp``, ``scan_pallas.py:_fused_vjp``) runs the kernel in
the forward, keeps only the inputs as residuals, and in the backward takes
``jax.vjp`` of the plain ``_reference`` composition on them.

``differentiable(kernel, plain)`` makes the same rule a
``torch.autograd.Function``:

* forward: ``kernel`` (the wrapper's counted CUDA launch) on a CUDA tensor,
  ``plain`` on a CPU tensor, with grad mode off as in any Function; it saves
  the tensor inputs and nothing else;
* backward: ``plain`` again on the saved inputs under ``torch.enable_grad()``,
  then ``torch.autograd.grad`` of its outputs with the incoming output
  gradients, which is tpuir's ``jax.vjp(_reference, ...)``. The backward
  launches no kernel.

Non-tensor arguments (scan_len, shift) pass through and get ``None``, as
tpuir's ``nondiff_argnums``. A wrapper sends every parity call through the
Function, on either device and in any grad mode (with no input that needs
a gradient, ``apply`` runs the forward alone), so the kernel's launch and
count live in one place and the CPU tests run the saving, the recompute
and the mapping of the gradients themselves.

``plain_forwards()`` makes the forward run ``plain`` on the card too, with
everything else the same: the twin that a kernel path's training steps are
held against.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Sequence

import torch

_PLAIN_FORWARD = contextvars.ContextVar("tpuir_plain_forward", default=False)


@contextlib.contextmanager
def plain_forwards() -> Iterator[None]:
    """Within this block, the Functions' forwards run their plain versions on
    a CUDA tensor as on a CPU one (no kernel launch)."""
    token = _PLAIN_FORWARD.set(True)
    try:
        yield
    finally:
        _PLAIN_FORWARD.reset(token)


class _KernelFunction(torch.autograd.Function):
    """One kernel's rule; ``spec`` is (kernel, plain, static arguments)."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        kernel, plain, static = spec
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        on_card = tensors[0].device.type == "cuda" and not _PLAIN_FORWARD.get()
        return (kernel if on_card else plain)(*tensors, *static)

    @staticmethod
    def backward(ctx, *grads):
        _, plain, static = ctx.spec
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            outs = plain(*inputs, *static)
        outs = outs if isinstance(outs, tuple) else (outs,)
        used = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in inputs if t.requires_grad]
        if not (used and wrt):
            return (None,) * (1 + len(needs))
        got = iter(torch.autograd.grad([o for o, _ in used], wrt, [g for _, g in used],
                                       allow_unused=True))
        return (None, *[next(got) if n else None for n in needs])


def differentiable(kernel: Callable, plain: Callable) -> Callable:
    """``call(tensors, static)``: ``kernel`` or ``plain`` of ``(*tensors,
    *static)`` through ``_KernelFunction``, differentiable in ``tensors`` as
    ``plain`` is. ``kernel`` runs only on CUDA tensors and counts its launch;
    ``plain`` is the same function in plain PyTorch."""

    def call(tensors: Sequence[torch.Tensor], static: Sequence = ()):
        return _KernelFunction.apply((kernel, plain, tuple(static)), *tensors)

    return call
