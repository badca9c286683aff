"""Score a network on an option file's test sets with the registry metrics.

    python -m tpuir_torch.scripts.test -opt options/test/XXX.yml [--device cuda|cpu]

The counterpart of ``scripts/test.py`` (BasicSR ``test.py:14-55``): the
option file's test datasets through ``model.validation``, one log line a
set; the weights are ``path: pretrain_network_g`` (a ``.pth``), or seeded
from ``manual_seed`` where the file names none. Runs on ``cuda:0`` unless
``--device cpu`` is given.
"""

import os

from tpuir_torch.train.options import parse_options
from tpuir_torch.train.pipeline import test_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, root_path: str = ROOT):
    opt, _ = parse_options(root_path, is_train=False, args=argv)
    return test_pipeline(root_path, opt)


if __name__ == "__main__":
    main()
