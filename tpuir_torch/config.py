"""Directory roots and per-model patch configuration.

The port's own copy of ``tpuir/config.py``: the dataset, weights and
results roots (``TPUIR_DATASET_DIR``, ``TPUIR_WEIGHTS_DIR``,
``TPUIR_RESULTS_DIR``), the patch table and its variant selection (the
original's ``get_patch_config``), held equal to it by
``tests/test_torch_host.py`` and ``tests/test_torch_harness.py``.
"""

from __future__ import annotations

import os

ROOT_DATASET_DIR = os.environ.get("TPUIR_DATASET_DIR", "datasets")
ROOT_WEIGHTS_DIR = os.environ.get("TPUIR_WEIGHTS_DIR", "weights")
ROOT_RESULTS_DIR = os.environ.get("TPUIR_RESULTS_DIR", "results")

PATCH_CONFIG = {
    "REDNet": {"patch_size": 128, "patch_overlap": 32},
    "DnCNN": {"patch_size": 256, "patch_overlap": 48},
    "DeblurGANv2": [
        {"patch_size": 768, "patch_overlap": 128},  # Inception
        {"patch_size": 2048, "patch_overlap": 384},  # MobileNet
    ],
    "Restormer": [
        {"patch_size": 256, "patch_overlap": 48},  # denoising
        {"patch_size": 512, "patch_overlap": 96},  # deblurring
    ],
    "MaIR": [
        {"patch_size": 128, "patch_overlap": 32},  # gaussian
        {"patch_size": 384, "patch_overlap": 128},  # real / motion
    ],
}


def get_patch_config(task: str, subtask: str, model_name: str) -> dict | None:
    task_key = task.lower()
    subtask_key = subtask.lower()
    model_key = model_name.split(" ")[0]
    config = PATCH_CONFIG.get(model_key, None)
    if isinstance(config, list):
        if model_key == "DeblurGANv2":
            config = config[0] if "Inception" in model_name else config[1]
        elif model_key == "MaIR":
            config = config[0] if subtask_key == "gaussian" else config[1]
        elif model_key == "Restormer":
            config = config[0] if task_key == "denoising" else config[1]
        else:
            config = config[0]
    return config
