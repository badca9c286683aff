"""Single-image smoke run of the port over the demo suites, on the card.

    python -m tpuir_torch.scripts.test_demo [--demo-dir demo] [--weights-dir DIR]
                                            [--device cuda] [--show]

The counterpart of ``scripts/test_demo.py``: the same suites, demo file
names (``<demo-dir>/<prefix>_{noisy,input,target}.*`` in,
``<demo-dir>/<prefix>_result_<Model>.png`` out), sigmas and model lists,
each model built through the port's zoo and served through its engine,
PSNR and SSIM printed. Missing weights or demo images print a skip. The
matplotlib panel (``<demo-dir>/<prefix>_panel.png``, shown with --show) is
drawn only where matplotlib imports; otherwise one line says that no panel
was drawn.
"""

import argparse
import os

import numpy as np

from tpuir_torch import zoo
from tpuir_torch.config import get_patch_config
from tpuir_torch.core.engine import run_model_inference
from tpuir_torch.core.image_io import imread_uint8, imread_uint16, imwrite_uint
from tpuir_torch.core.metrics import calculate_metrics

SUITES = [
    # (prefix, task, subtask, gray, sigma, models, noisy_suffix, target_suffix)
    ("denoising_gaussian_gray_nonblind", "denoising", "gaussian", True, 50,
     ["REDNet", "DnCNN", "Restormer"], "noisy.bmp", "target.png"),
    ("denoising_gaussian_gray_blind", "denoising", "gaussian", True, 25,
     ["DnCNN", "Restormer"], "noisy.bmp", "target.png"),
    ("denoising_gaussian_color_nonblind", "denoising", "gaussian", False, 25,
     ["Restormer", "MaIR"], "noisy.bmp", "target.png"),
    ("denoising_gaussian_color_blind", "denoising", "gaussian", False, 25,
     ["DnCNN", "Restormer"], "noisy.bmp", "target.png"),
    ("denoising_real", "denoising", "real", False, None,
     ["Restormer", "MaIR"], "noisy.bmp", "target.bmp"),
    ("deblurring_motion", "deblurring", "motion", False, None,
     ["DeblurGANv2 (Inception)", "DeblurGANv2 (MobileNet)", "Restormer", "MaIR"],
     "input.png", "target.png"),
]


def _clean(model_name):
    return model_name.replace(" ", "_").replace("(", "").replace(")", "")


class _Panel:
    """The suite's matplotlib panel, or nothing where matplotlib is absent."""

    def __init__(self, ncols, show):
        try:
            import matplotlib
        except ImportError:
            self.plt = None
            return
        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt, self.ncols, self.show = plt, ncols, show
        plt.figure(figsize=(3 * ncols, 6), dpi=150)

    def add(self, index, title, img, cmap):
        if self.plt is not None:
            self.plt.subplot(2, self.ncols, index)
            self.plt.title(title)
            self.plt.axis("off")
            self.plt.imshow(img.squeeze(), cmap=cmap)

    def save(self, path):
        if self.plt is None:
            print(f"  no panel drawn ({os.path.basename(path)}): matplotlib is not installed")
            return
        self.plt.savefig(path, bbox_inches="tight")
        if self.show:
            self.plt.show()
        self.plt.close()


def run_suite(prefix, task, subtask, gray, sigma, models, noisy_suffix,
              target_suffix, demo_dir, weights_dir, show, device="cuda"):
    in_path = os.path.join(demo_dir, f"{prefix}_{noisy_suffix}")
    tgt_path = os.path.join(demo_dir, f"{prefix}_{target_suffix}")
    if not (os.path.exists(in_path) and os.path.exists(tgt_path)):
        print(f"[skip] demo images for {prefix} not found")
        return
    n_ch = 1 if gray else 3
    input_img = imread_uint8(in_path, n_channels=n_ch)
    target_img = imread_uint8(tgt_path, n_channels=n_ch)

    ncols = max(3, len(models))
    cmap = "gray" if gray else None
    panel = _Panel(ncols, show)
    panel.add(1, "Input", input_img, cmap)
    panel.add(2, "Target", target_img, cmap)
    for i, model_name in enumerate(models):
        print(f"\nTesting {model_name} on {prefix}...")
        # blind variants of the gaussian suites load sigma-free weights
        # (note: "nonblind" contains "blind", so match the suffix)
        load_sigma = None if prefix.endswith("_blind") else sigma
        try:
            model = zoo.get_model_instance(
                task, subtask, model_name, gray=gray, sigma=load_sigma,
                weights_dir=weights_dir, device=device,
            )
        except FileNotFoundError:
            print(f"Model weights for {model_name} not found. Skipping this model.")
            continue
        pc = get_patch_config(task, subtask, model_name)
        pred, ms = run_model_inference(model, input_img, patch_size=pc["patch_size"],
                                       patch_overlap=pc["patch_overlap"])
        p, s = calculate_metrics(pred, target_img)
        print(f"  PSNR {p:.2f} dB  SSIM {s:.4f}  ({ms:.0f} ms)")
        imwrite_uint(os.path.join(demo_dir, f"{prefix}_result_{_clean(model_name)}.png"), pred)
        panel.add(ncols + 1 + i, model_name, pred, cmap)
    panel.save(os.path.join(demo_dir, f"{prefix}_panel.png"))


def run_defocus(demo_dir, weights_dir, show, device="cuda"):
    prefix = "deblurring_defocus"
    c_path = os.path.join(demo_dir, f"{prefix}_input.png")
    t_path = os.path.join(demo_dir, f"{prefix}_target.png")
    if not os.path.exists(t_path):
        print(f"[skip] demo images for {prefix} not found")
        return
    target_img = imread_uint8(t_path)
    for model_name in ["Restormer", "Restormer (Dual-pixel)"]:
        dual = "Dual-pixel" in model_name
        paths = ([os.path.join(demo_dir, f"{prefix}_input{side}.png") for side in "LR"]
                 if dual else [c_path])
        if not all(os.path.exists(p) for p in paths):
            print(f"[skip] defocus input for {model_name} not found")
            continue
        input_img = (np.concatenate([imread_uint16(p) for p in paths], axis=2) if dual
                     else imread_uint8(c_path))
        try:
            model = zoo.get_model_instance("deblurring", "defocus", model_name,
                                           weights_dir=weights_dir, device=device)
        except FileNotFoundError:
            print(f"Model weights for {model_name} not found. Skipping this model.")
            continue
        pc = get_patch_config("deblurring", "defocus", model_name)
        pred, ms = run_model_inference(model, input_img, patch_size=pc["patch_size"],
                                       patch_overlap=pc["patch_overlap"])
        pred8 = (pred / 257).round().astype(np.uint8) if pred.dtype == np.uint16 else pred
        p, s = calculate_metrics(pred8, target_img)
        print(f"  {model_name}: PSNR {p:.2f} dB SSIM {s:.4f} ({ms:.0f} ms)")
        imwrite_uint(os.path.join(demo_dir, f"{prefix}_result_{_clean(model_name)}.png"), pred8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo-dir", default="demo")
    ap.add_argument("--weights-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    for suite in SUITES:
        run_suite(*suite, demo_dir=args.demo_dir, weights_dir=args.weights_dir,
                  show=args.show, device=args.device)
    run_defocus(args.demo_dir, args.weights_dir, args.show, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
