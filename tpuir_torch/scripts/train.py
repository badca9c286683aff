"""Train a network from a BasicSR option file on the card.

    python -m tpuir_torch.scripts.train -opt options/train/XXX.yml [--auto_resume]
        [--force_yml train:total_iter=1000 ...] [--device cuda|cpu]

The counterpart of ``scripts/train.py``: it reads the same option files
(``train/options.py``) and runs ``train/pipeline.train_pipeline``, writing
``experiments/<name>/`` under the repository root: ``models/net_g_*.pth``
and ``training_states/*.state``. It trains on ``cuda:0`` unless
``--device cpu`` is given, and raises where no card is found. Only
``--launcher none`` is taken (one card).
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
