"""Parallelism over GPUs, the counterpart of ``tpuir/parallel/``: one
process a GPU (torchrun's model) in a ``torch.distributed`` group, NCCL
for CUDA tensors and gloo for CPU tensors, with tpuir's mesh axes ``dp``,
``sp`` and ``tp``.

  dist.py         init_dist, get_dist_info, master_only (BasicSR's dist_util)
  mesh.py         the ranks on dp, sp and tp: make_mesh, batch_sharding, replicate
  collectives.py  all-reduce and all-gather as autograd Functions on an axis's group
  spatial.py      sp: halo convs, MDTA's sums, the mixer on the gathered height
  tensor.py       tp: shard_params_tp, column-parallel layers, full_state_dict
  train.py        the train step on a mesh (gradients averaged over dp x sp)
  inference.py    run_model_inference_sharded: the patch grid split over dp
  launch.py       a world of spawned processes on one host, with a time limit
  jobs.py         what a rank runs under launch (sharded serving, DDP steps,
                  the training script)
  dryrun.py       tpuir's dryrun_multichip: dp x sp x tp training steps, K2
                  under dp and sharded inference on one mesh

Training under DDP (``dp`` alone) is ``train/model.py``'s, with
``--launcher pytorch`` (``train/options.py``).
"""

from tpuir_torch.parallel.dist import get_dist_info, init_dist, master_only  # noqa: F401
from tpuir_torch.parallel.mesh import batch_sharding, make_mesh, replicate  # noqa: F401
from tpuir_torch.parallel.tensor import full_state_dict, shard_params_tp  # noqa: F401
