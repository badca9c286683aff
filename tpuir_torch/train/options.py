"""Option files: BasicSR's YAML dialect, as ``tpuir/train/options.py`` parses it.

Ordered YAML with ``!!float`` tags, the CLI overrides ``-opt``,
``--launcher``, ``--auto_resume``, ``--debug`` and ``--force_yml``, seed
handling, path expansion and ``num_gpu: auto``. One process on one card:
``--launcher`` takes only ``none`` (multi-GPU training is not ported: ROADMAP
Queue 1 item 4), so ``dist`` is False, ``rank`` 0 and ``world_size`` 1.
``num_gpu: auto`` becomes ``torch.cuda.device_count()``, which is 0 where
torch has no CUDA (tpuir's ``len(jax.devices())`` counts the CPU as one
device); ``--device`` (default ``cuda``) names the device the scripts train
and test on, stored as ``opt["device"]``.
"""

from __future__ import annotations

import argparse
import os
import random
from collections import OrderedDict
from os import path as osp

import torch


def ordered_yaml():
    """Ordered yaml Loader/Dumper (BasicSR options.py:12-34). PyYAML is
    imported here, so the rest of the training core imports without it."""
    import yaml

    try:
        from yaml import CDumper as Dumper, CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    _mapping_tag = yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(_mapping_tag, dict_constructor)
    return Loader, Dumper


def yaml_load(f):
    import yaml

    if f.endswith((".yml", ".yaml")) and os.path.exists(f):
        with open(f) as fh:
            return yaml.load(fh, Loader=ordered_yaml()[0])
    return yaml.load(f, Loader=ordered_yaml()[0])


def dict2str(opt, indent_level=1):
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg


def _postprocess_yml_value(value: str):
    if value == "~" or value.lower() == "none":
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.startswith("["):
        return eval(value)  # noqa: S307 — list literals, as the reference does
    if value.isdigit():
        return int(value)
    try:
        return float(value)
    except ValueError:
        return value


def apply_force_yml(opt, force_yml):
    """--force_yml 'train:ema_decay=0.999' style overrides."""
    for entry in force_yml or []:
        keys, value = entry.split("=", 1)
        keys = keys.strip().split(":")
        d = opt
        for k in keys[:-1]:
            d = d[k.strip()]
        d[keys[-1].strip()] = _postprocess_yml_value(value.strip())
    return opt


def parse_options(root_path: str, is_train: bool = True, args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="option YAML file")
    parser.add_argument(
        "--launcher", default="none",
        help="multi-process launcher: only 'none' (one process on one card)",
    )
    parser.add_argument("--device", default="cuda",
                        help="device to train or test on: cuda (the default) or cpu")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--force_yml", nargs="+", default=None)
    parsed = parser.parse_args(args)

    opt = yaml_load(parsed.opt)

    if parsed.launcher != "none":
        raise NotImplementedError(
            f"--launcher {parsed.launcher}: multi-GPU training is not ported to tpuir_torch "
            "(ROADMAP Queue 1 item 4); use --launcher none")
    opt["dist"] = False
    opt["rank"] = 0
    opt["world_size"] = 1
    opt["device"] = parsed.device

    apply_force_yml(opt, parsed.force_yml)

    seed = opt.get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
        opt["manual_seed"] = seed

    opt["auto_resume"] = parsed.auto_resume
    opt["is_train"] = is_train
    if parsed.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]

    if opt.get("num_gpu") == "auto":
        opt["num_gpu"] = torch.cuda.device_count()

    # dataset augmentations
    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        for key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(key) is not None and isinstance(dataset[key], str):
                dataset[key] = osp.expanduser(dataset[key])

    # paths
    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val is not None and ("resume_state" in key or "pretrain_network" in key):
            opt["path"][key] = osp.expanduser(val)
    if is_train:
        experiments_root = osp.join(root_path, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_states"] = osp.join(experiments_root, "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = osp.join(experiments_root, "visualization")
    else:
        results_root = osp.join(root_path, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = osp.join(results_root, "visualization")

    return opt, parsed
