"""The training side of the port: ``tpuir/train``'s options, losses,
schedules, data, networks, train step, model wrappers and pipelines on
PyTorch (``tpuir_torch/scripts/{train,test,testM}.py`` drive them), the
extra datasets (``video_datasets``), DeblurGANv2's training parts
(``deblurgan_losses``, ``deblurgan_aug``, ``deblurgan_metrics``,
``vgg_features``; its discriminators and extra generators are in
``models/deblurgan/``) and the extra metrics (``extra_metrics``: NIQE and
FID, with ``fid_inception``). Importing it fills the registries of
``tpuir_torch/registry.py`` as importing ``tpuir.train`` fills tpuir's.

Multi-GPU training (``--launcher pytorch|slurm``) runs the model wrappers
under DistributedDataParallel over ``tpuir_torch/parallel/``'s group.
"""

from tpuir_torch.train import archs, data, losses, metrics, model, schedulers  # noqa: F401
from tpuir_torch.train import video_datasets  # noqa: F401
from tpuir_torch.train.trainer import TrainState, build_optimizer, train_step  # noqa: F401
