"""tpuir_torch — the PyTorch and CUDA port of tpuir, for one NVIDIA H100.

It sits beside ``tpuir/`` (the JAX package, which stays the reference the
port is held against) and mirrors its module names. It imports ``torch``
and never ``jax``, ``flax`` or anything of ``tpuir``: what it needs of
tpuir's JAX-free code (the patch table, the host gather and blend, the NSS
scan ids) it keeps as its own copies.

Layout:
  config.py  the patch table
  core/      tiled inference engine; host gather/blend (C++, g++ at first use);
             NumPy copies of tiling, AWGN, image IO, metrics
  ops/       kernel wrappers, each with its plain PyTorch version and a launch count
  csrc/      CUDA C++ kernels for Hopper (sm_90a), built with nvcc at first use
  models/    nn.Modules with the released checkpoints' key names (Restormer, MaIR)
  utils/     small host-side utilities and torch.profiler helpers
  zoo.py     (task, subtask, model) -> loaded InferenceModel, on the card by default
"""

__version__ = "0.1.0"
