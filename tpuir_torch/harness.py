"""Evaluation harness of the port: the 7-suite test matrix, one CSV row a cell.

    python -m tpuir_torch.harness [--weights-dir DIR] [--results-dir DIR]
                                  [--no-save-images] [--suites NAME ...]

The counterpart of ``tpuir/harness.py`` and of ``scripts/tests.py``'s
command line, run on the port's zoo and engine: the same seven suites with
the same defaults, the same cell runner (zoo -> ``core.engine.
run_model_inference`` with the suite's patch configuration and host AWGN ->
``core.metrics.calculate_metrics``), the same CSV columns and Type strings
in ``results_summary.csv`` under the results root, for all five families
(DnCNN, REDNet and DeblurGANv2 in the gray, blind and motion suites). A
cell whose weights are absent (``FileNotFoundError``) prints a skip and
adds no row. Models run on the card unless ``device`` says otherwise; precision,
MaIR's NSS route and K2's bf16 recurrence follow the zoo's knobs
(``TPUIR_PRECISION``, ``TPUIR_NSS``, ``TPUIR_RECUR_BF16``) unless given.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Union

import numpy as np
import torch

from tpuir_torch import zoo
from tpuir_torch.config import ROOT_RESULTS_DIR, get_patch_config
from tpuir_torch.core.engine import run_model_inference
from tpuir_torch.core.image_io import imwrite_uint
from tpuir_torch.core.metrics import calculate_metrics
from tpuir_torch.data import loaders

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = lambda x, **k: x  # noqa: E731

COLUMNS = ("Task", "Type", "Dataset", "Sigma", "Model", "Model_Params", "PSNR", "SSIM",
           "Std_PSNR", "Std_SSIM", "Avg_Time_ms", "Std_Time_ms")


def save_result_image(pred, test_name, dataset_name, model_name, img_name, out_root=None):
    out_root = out_root or os.environ.get("TPUIR_RESULTS_DIR", ROOT_RESULTS_DIR)
    dir_path = os.path.join(out_root, test_name, dataset_name, model_name)
    os.makedirs(dir_path, exist_ok=True)
    imwrite_uint(os.path.join(dir_path, img_name), pred)


def _row(task, type_label, dataset, sigma, model_name, model, psnrs, ssims, times) -> dict:
    return {
        "Task": task, "Type": type_label, "Dataset": dataset, "Sigma": sigma,
        "Model": model_name, "Model_Params": model.param_count,
        "PSNR": np.mean(psnrs), "SSIM": np.mean(ssims),
        "Std_PSNR": np.std(psnrs), "Std_SSIM": np.std(ssims),
        "Avg_Time_ms": np.mean(times), "Std_Time_ms": np.std(times),
    }


class Harness:
    def __init__(self, weights_dir: Optional[str] = None, save_images: bool = True,
                 results_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", precision: Optional[str] = None,
                 nss: Optional[str] = None, recur_bf16: Optional[bool] = None):
        self.weights_dir = weights_dir
        self.save_images = save_images
        self.results_dir = results_dir or os.environ.get("TPUIR_RESULTS_DIR", ROOT_RESULTS_DIR)
        self.device = device
        self.model_kw = dict(precision=precision, nss=nss, recur_bf16=recur_bf16)
        self.results_table: List[dict] = []

    def _model(self, task, subtask, model_name, gray, sigma):
        """The zoo's model, or None (a skip printed) where the weights are
        absent."""
        try:
            return zoo.get_model_instance(task, subtask, model_name, gray=gray, sigma=sigma,
                                          weights_dir=self.weights_dir, device=self.device,
                                          **self.model_kw)
        except FileNotFoundError:
            print(f"Model weights for {model_name} not found. Skipping this model.")
        return None

    # -- generic cell runner ------------------------------------------------

    def _run_cell(
        self, *, test_name, task_label, type_label, task, subtask, dataset_name,
        sigma, model_name, loader, gray=False, need_degradation=False,
        save_name_fn=None,
    ):
        model = self._model(task, subtask, model_name, gray,
                            sigma if need_degradation or subtask == "gaussian" else None)
        if model is None:
            return
        patch_config = get_patch_config(task, subtask, model_name)
        psnr_list, ssim_list, time_list = [], [], []
        for idx, item in enumerate(tqdm(loader, desc=model_name)):
            if len(item) == 3:
                input_img, target_img, img_name = item
            else:
                if need_degradation:  # gaussian: clean image only
                    input_img, img_name = item
                    target_img = input_img
                else:  # SIDD pairs without names
                    input_img, target_img = item
                    img_name = f"{idx:04d}.png"
            pred, t_ms = run_model_inference(
                model, input_img,
                patch_size=patch_config["patch_size"],
                patch_overlap=patch_config["patch_overlap"],
                need_degradation=need_degradation,
                noise_level=sigma if need_degradation else None,
            )
            p, s = calculate_metrics(pred, target_img)
            psnr_list.append(p)
            ssim_list.append(s)
            time_list.append(t_ms)
            if self.save_images:
                ds_dir = f"{dataset_name}_Sig{sigma}" if need_degradation else dataset_name
                mname = save_name_fn(model_name) if save_name_fn else model_name
                save_result_image(pred, test_name, ds_dir, mname, img_name, self.results_dir)
        self.results_table.append(_row(task_label, type_label, dataset_name,
                                       sigma if need_degradation else "N/A", model_name, model,
                                       psnr_list, ssim_list, time_list))

    def _run_blind_cell(self, test_name, type_label, ds, sigma, model_name, loader, gray):
        model = self._model("denoising", "gaussian", model_name, gray, None)
        if model is None:
            return
        patch_config = get_patch_config("denoising", "gaussian", model_name)
        psnr_list, ssim_list, time_list = [], [], []
        for clean_img, img_name in tqdm(loader, desc=model_name):
            pred, t_ms = run_model_inference(
                model, clean_img,
                patch_size=patch_config["patch_size"],
                patch_overlap=patch_config["patch_overlap"],
                need_degradation=True, noise_level=sigma,
            )
            p, s = calculate_metrics(pred, clean_img)
            psnr_list.append(p)
            ssim_list.append(s)
            time_list.append(t_ms)
            if self.save_images:
                save_result_image(pred, test_name, f"{ds}_Sig{sigma}", model_name, img_name,
                                  self.results_dir)
        self.results_table.append(_row("Denoising", type_label, ds, sigma, model_name, model,
                                       psnr_list, ssim_list, time_list))

    # -- the 7 suites (the defaults of scripts/tests.py) --------------------

    def gaussian_gray_nonblind(self, datasets=("Set12", "BSD68", "Urban100"),
                               sigmas=(15, 25, 50),
                               models=("REDNet", "DnCNN", "Restormer")):
        for ds in datasets:
            for sigma in sigmas:
                loader = loaders.gaussian_noise_dataset_loader(ds, n_channels=1)
                for m in models:
                    self._run_cell(
                        test_name="Gaussian_Denoising_Gray_Nonblind",
                        task_label="Denoising", type_label="Gray Non-blind Gaussian Noise",
                        task="denoising", subtask="gaussian", dataset_name=ds,
                        sigma=sigma, model_name=m, loader=loader, gray=True,
                        need_degradation=True,
                    )

    def gaussian_gray_blind(self, datasets=("Set12", "BSD68", "Urban100"),
                            sigmas=(15, 25, 50), models=("DnCNN", "Restormer")):
        for ds in datasets:
            for sigma in sigmas:
                loader = loaders.gaussian_noise_dataset_loader(ds, n_channels=1)
                for m in models:
                    self._run_blind_cell(
                        "Gaussian_Denoising_Gray_Blind", "Gray Blind Gaussian Noise",
                        ds, sigma, m, loader, gray=True,
                    )

    def gaussian_color_nonblind(self, datasets=("CBSD68", "Kodak", "McMaster", "Urban100"),
                                sigmas=(15, 25, 50), models=("Restormer", "MaIR")):
        for ds in datasets:
            for sigma in sigmas:
                loader = loaders.gaussian_noise_dataset_loader(ds, n_channels=3)
                for m in models:
                    self._run_cell(
                        test_name="Gaussian_Denoising_Color_Nonblind",
                        task_label="Denoising", type_label="Color Non-blind Gaussian Noise",
                        task="denoising", subtask="gaussian", dataset_name=ds,
                        sigma=sigma, model_name=m, loader=loader, gray=False,
                        need_degradation=True,
                    )

    def gaussian_color_blind(self, datasets=("CBSD68", "Kodak", "McMaster", "Urban100"),
                             sigmas=(15, 25, 50), models=("DnCNN", "Restormer")):
        for ds in datasets:
            for sigma in sigmas:
                loader = loaders.gaussian_noise_dataset_loader(ds, n_channels=3)
                for m in models:
                    self._run_blind_cell(
                        "Gaussian_Denoising_Color_Blind", "Color Blind Gaussian Noise",
                        ds, sigma, m, loader, gray=False,
                    )

    def real_noise(self, models=("Restormer", "MaIR")):
        try:
            loader = loaders.real_noise_dataset_loader("SIDD")
        except FileNotFoundError:
            print("SIDD validation data not found. Skipping real-noise suite.")
            return
        for m in models:
            self._run_cell(
                test_name="Real_Noise_Denoising", task_label="Denoising",
                type_label="Real Noise", task="denoising", subtask="real",
                dataset_name="SIDD", sigma=None, model_name=m, loader=loader,
            )

    def defocus_blur(self, models=("Restormer", "Restormer (Dual-pixel)")):
        for m in models:
            loader = loaders.defocus_blur_dataset_loader("DPDD", dual_pixel="Dual-pixel" in m)
            self._run_cell(
                test_name="Defocus_Deblurring", task_label="Deblurring",
                type_label="Defocus", task="deblurring", subtask="defocus",
                dataset_name="DPDD", sigma=None, model_name=m, loader=loader,
                save_name_fn=lambda n: n.replace(" ", "_").replace("(", "").replace(")", ""),
            )

    def motion_blur(self, datasets=("GoPro", "HIDE", "RealBlur_J", "RealBlur_R"),
                    models=("DeblurGANv2 (Inception)", "DeblurGANv2 (MobileNet)",
                            "Restormer", "MaIR")):
        for ds in datasets:
            loader = loaders.motion_blur_dataset_loader(ds)
            for m in models:
                self._run_cell(
                    test_name="Motion_Deblurring", task_label="Deblurring",
                    type_label="Motion", task="deblurring", subtask="motion",
                    dataset_name=ds, sigma=None, model_name=m, loader=loader,
                    save_name_fn=lambda n: n.replace(" ", "_").replace("(", "").replace(")", ""),
                )

    def run_all(self):
        self.gaussian_gray_nonblind()
        self.gaussian_gray_blind()
        self.gaussian_color_nonblind()
        self.gaussian_color_blind()
        self.real_noise()
        self.defocus_blur()
        self.motion_blur()

    def save_results(self, out_dir: Optional[str] = None,
                     file_name: str = "results_summary.csv") -> str:
        import pandas as pd

        out_dir = out_dir or self.results_dir
        os.makedirs(out_dir, exist_ok=True)
        output_path = os.path.join(out_dir, file_name)
        df = pd.DataFrame(self.results_table)
        df.to_csv(output_path, index=False)
        print(f"\nResults saved to {output_path}")
        if len(df):
            print(df.to_string(index=False))
        return output_path


SUITES = ("gray_nonblind", "gray_blind", "color_nonblind", "color_blind", "real", "defocus",
          "motion")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights-dir", default=None)
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--no-save-images", action="store_true")
    ap.add_argument("--suites", nargs="*", default=None, help="subset of: " + " ".join(SUITES))
    args = ap.parse_args(argv)
    device = "cuda"
    print(f"Using device: {torch.cuda.get_device_name(0) if torch.cuda.is_available() else device}")
    h = Harness(weights_dir=args.weights_dir, save_images=not args.no_save_images,
                results_dir=args.results_dir, device=device)
    suite_map = dict(zip(SUITES, (h.gaussian_gray_nonblind, h.gaussian_gray_blind,
                                  h.gaussian_color_nonblind, h.gaussian_color_blind,
                                  h.real_noise, h.defocus_blur, h.motion_blur)))
    if args.suites:
        for s in args.suites:
            suite_map[s]()
    else:
        h.run_all()
    h.save_results()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
