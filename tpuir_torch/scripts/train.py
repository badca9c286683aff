"""Train a network from a BasicSR option file on the card.

    python -m tpuir_torch.scripts.train -opt options/train/XXX.yml [--auto_resume]
        [--force_yml train:total_iter=1000 ...] [--device cuda|cpu]
    torchrun --nproc_per_node N -m tpuir_torch.scripts.train -opt ... --launcher pytorch

The counterpart of ``scripts/train.py``: it reads the same option files
(``train/options.py``) and runs ``train/pipeline.train_pipeline``, writing
``experiments/<name>/`` under the repository root: ``models/net_g_*.pth``
and ``training_states/*.state``. It trains on ``cuda:0`` unless
``--device cpu`` is given, and raises where no card is found. Under
``torchrun`` with ``--launcher pytorch`` (or SLURM with ``--launcher
slurm``) each process trains on ``cuda:LOCAL_RANK`` (``--device cpu``: on
the CPU over gloo) under DistributedDataParallel, reading its share of each
epoch; ``batch_size_per_gpu`` is each process's batch, and rank 0 alone
writes the logs and checkpoints.
"""

import os

from tpuir_torch.train.options import parse_options
from tpuir_torch.train.pipeline import train_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, root_path: str = ROOT):
    opt, _ = parse_options(root_path, is_train=True, args=argv)
    return train_pipeline(root_path, opt)


if __name__ == "__main__":
    main()
