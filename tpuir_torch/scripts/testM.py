"""Score every saved checkpoint of a run on an option file's test sets.

    python -m tpuir_torch.scripts.testM -opt options/test/XXX.yml \
        --models-dir experiments/NAME/models [--step 4000] [--device cuda|cpu]

The counterpart of ``scripts/testM.py`` (BasicSR ``testM.py:13-55``): each
``net_g_<iter>.pth`` in ``--models-dir`` whose iteration is a multiple of
``--step``, in order, through ``model.validation``; one log line a
checkpoint and set. Returns {iter: {set: metrics}}.
"""

import argparse
import glob
import os
import re

from tpuir_torch.train.logging_utils import get_root_logger
from tpuir_torch.train.model import build_model
from tpuir_torch.train.options import parse_options
from tpuir_torch.train.pipeline import create_train_val_dataloader

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def checkpoints(models_dir: str, step: int = 1):
    """[(iter, path)] of the ``net_g_<iter>.pth`` files, by iteration."""
    found = []
    for p in glob.glob(os.path.join(models_dir, "net_g_*.pth")):
        m = re.search(r"net_g_(\d+)\.pth$", p)
        if m and int(m.group(1)) % step == 0:
            found.append((int(m.group(1)), p))
    return sorted(found)


def main(argv=None, root_path: str = ROOT):
    sweep = argparse.ArgumentParser(add_help=False)
    sweep.add_argument("--models-dir", required=True)
    sweep.add_argument("--step", type=int, default=1)
    sweep_args, rest = sweep.parse_known_args(argv)

    opt, _ = parse_options(root_path, is_train=False, args=rest)
    logger = get_root_logger()
    _, val_loaders = create_train_val_dataloader(opt, logger)
    model = build_model(opt)
    results = {}
    for it, path in checkpoints(sweep_args.models_dir, sweep_args.step):
        model.load_network(path)
        results[it] = {}
        for name, loader in val_loaders:
            results[it][name] = model.validation(loader)
            logger.info(f"iter {it} | {name}: {results[it][name]}")
    return results


if __name__ == "__main__":
    main()
