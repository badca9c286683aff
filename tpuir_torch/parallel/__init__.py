"""Data parallelism over GPUs, the counterpart of ``tpuir/parallel/``: one
process a GPU (torchrun's model) in a ``torch.distributed`` group, NCCL
for CUDA tensors and gloo for CPU tensors.

  dist.py       init_dist, get_dist_info, master_only (BasicSR's dist_util)
  mesh.py       the ranks on one 'dp' axis: batch_sharding, replicate
  inference.py  run_model_inference_sharded: the patch grid split over ranks
  launch.py     a world of spawned processes on one host, with a time limit
  jobs.py       what a rank runs under launch (sharded serving, DDP steps,
                the training script)

Training under DDP is ``train/model.py``'s, with ``--launcher pytorch``
(``train/options.py``).
"""

from tpuir_torch.parallel.dist import get_dist_info, init_dist, master_only  # noqa: F401
from tpuir_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicate,
    shard_params_tp,
)
