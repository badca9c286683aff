"""The training core of the port: ``tpuir/train``'s options, losses,
schedules, data, networks, train step, model wrappers and pipelines on
PyTorch (``tpuir_torch/scripts/{train,test,testM}.py`` drive them).
Importing it fills the registries of ``tpuir_torch/registry.py``.

Left out, as ROADMAP Queue 1 says: DeblurGANv2's training modules, the
extra metrics and video datasets (item 3), and multi-GPU (item 4).
"""

from tpuir_torch.train import archs, data, losses, metrics, model, schedulers  # noqa: F401
from tpuir_torch.train.trainer import TrainState, build_optimizer, train_step  # noqa: F401
