"""Plain-Python core of the demo, importable and testable without gradio:
the counterpart of ``tpuir/demo_core.py`` on the port.

Holds the task table, the model-availability matrix, the sample-gallery
scan, the device selector's values and the three event handlers
(``run_restoration``, ``subtask_change``, ``gallery_select``) that
``tpuir_torch/scripts/demo.py`` wires into its gradio Blocks. The tables and
the handlers' payloads are tpuir's; a restoration runs through the port's
zoo and engine on the card unless the caller picks another device.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from tpuir_torch import zoo
from tpuir_torch.config import ROOT_DATASET_DIR, get_patch_config
from tpuir_torch.core.degrade import add_gaussian_noise
from tpuir_torch.core.engine import run_model_inference
from tpuir_torch.core.image_io import imread_uint8
from tpuir_torch.utils.natsort import natsorted

# label -> (task, subtask, gray, sigmas or None=blind/n.a.)
TASKS = {
    "Denoising": {
        "Gaussian (Gray, Non-blind)": ("denoising", "gaussian", True, [15, 25, 50]),
        "Gaussian (Gray, Blind)": ("denoising", "gaussian", True, None),
        "Gaussian (Color, Non-blind)": ("denoising", "gaussian", False, [15, 25, 50]),
        "Gaussian (Color, Blind)": ("denoising", "gaussian", False, None),
        "Real Noise": ("denoising", "real", False, None),
    },
    "Deblurring": {
        "Defocus": ("deblurring", "defocus", False, None),
        "Motion": ("deblurring", "motion", False, None),
    },
}

SUBTASK_DATASET_DIRS = {
    ("denoising", "gaussian"): os.path.join("denoising", "gaussian", "test"),
    ("deblurring", "defocus"): os.path.join("deblurring", "defocus", "test"),
    ("deblurring", "motion"): os.path.join("deblurring", "motion", "test"),
}


def lookup_subtask(label):
    """Resolve a UI label to (task, subtask, gray, sigmas)."""
    for subs in TASKS.values():
        if label in subs:
            return subs[label]
    raise ValueError(f"unknown subtask label: {label!r}")


def available_models(task, subtask, gray, blind):
    """The model-availability matrix (tpuir's)."""
    if task == "denoising" and subtask == "gaussian":
        if gray:
            return ["DnCNN", "Restormer"] if blind else ["REDNet", "DnCNN", "Restormer"]
        return ["DnCNN", "Restormer"] if blind else ["Restormer", "MaIR"]
    if task == "denoising" and subtask == "real":
        return ["Restormer", "MaIR"]
    if task == "deblurring" and subtask == "defocus":
        return ["Restormer", "Restormer (Dual-pixel)"]
    if task == "deblurring" and subtask == "motion":
        return ["DeblurGANv2 (Inception)", "DeblurGANv2 (MobileNet)", "Restormer", "MaIR"]
    return []


def sample_images(task, subtask, max_n=12):
    rel = SUBTASK_DATASET_DIRS.get((task, subtask))
    if rel is None:
        return []
    root = os.path.join(os.environ.get("TPUIR_DATASET_DIR", ROOT_DATASET_DIR), rel)
    files = []
    for ds in sorted(glob(os.path.join(root, "*"))):
        sub = os.path.join(ds, "input") if os.path.isdir(os.path.join(ds, "input")) else ds
        files += natsorted(glob(os.path.join(sub, "*.*")))[:3]
    return files[:max_n]


def device_choices():
    """The devices the selector offers: ``cuda:i`` for each visible card,
    then ``cpu``."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())] + ["cpu"]


def subtask_change(label):
    """Dropdown-change handler payload: (models, sigma_visible, patch_size,
    patch_overlap, sample_paths), plain data, no gradio types."""
    task, sub, gray, sigmas = lookup_subtask(label)
    models = available_models(task, sub, gray, "Blind" in label)
    pc = get_patch_config(task, sub, models[0]) or {}
    samples = sample_images(task, sub)
    return (
        models,
        sigmas is not None,
        pc.get("patch_size", 256),
        pc.get("patch_overlap", 48),
        samples,
    )


def gallery_select(paths, index):
    """Gallery-select handler: load sample ``index`` of the known list."""
    return imread_uint8(paths[index])


def run_restoration(image, subtask_label, model_name, sigma, add_noise,
                    patch_size, patch_overlap, device_name=None, progress=None,
                    get_model=None):
    """The Restore-button handler. Returns (model_input_img, restored_img,
    time_string).

    The model is built on ``device_name`` ("cuda" when None) through
    ``get_model`` (default: the port's zoo router; tests inject a tiny
    model), which is passed ``device=``."""
    task, subtask, gray, sigmas = lookup_subtask(subtask_label)
    if image is None:
        raise ValueError("upload or pick an image first")
    img = np.asarray(image)
    if gray and img.ndim == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
        img = img.round().astype(np.uint8)[:, :, None]
    blind = "Blind" in subtask_label
    get_model = get_model or zoo.get_model_instance
    model = get_model(
        task, subtask, model_name, gray=gray,
        sigma=None if blind or sigmas is None else sigma,
        device=device_name or "cuda",
    )
    if add_noise and subtask == "gaussian":
        img = (add_gaussian_noise(img, sigma) * 255).round().astype(np.uint8)
    pred, ms = run_model_inference(
        model, img, patch_size=int(patch_size), patch_overlap=int(patch_overlap),
        progress_cb=progress,
    )
    return img.squeeze(), pred.squeeze(), f"{ms:.0f} ms"
