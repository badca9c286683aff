"""Serving precision against float32 parity, through the port's engine, on the card.

    python -m tpuir_torch.scripts.validate_serving [--weights-dir weights]
        [--families DnCNN,Restormer,...] [--size 256x320]
        [--device cuda] [--out results/serving_deltas_torch.json]

The counterpart of ``scripts/validate_serving.py``: for each family
(``FAMILIES``) the same image goes through ``core.engine.run_model_inference``
with the model built by the zoo in parity and in serving precision, and the
uint8 deltas and the agreement PSNR of the two outputs are recorded
(``delta_stats``, tpuir's), in two sections with tpuir's keys:

- ``deltas``: seeded weights as drawn (the worst case for bf16 rounding;
  trained restoration nets are near-identity), the image served as it is,
  with each path's engine ms (a second run, after a warm-up);
- ``trained_like``: the released checkpoint where the zoo finds it under
  ``--weights-dir``, else seeded weights with the output head scaled by
  0.05 (tpuir's ``_scale_head``); the clean image with host AWGN of the
  family's sigma (deblurring: the clean image as it is), each path's PSNR
  against it and their difference. Each entry says which weights it used.

The image is a seeded synthetic one of ``--size`` (no demo image is in
the repository). The JSON goes to ``--out``, never under ``benchmarks/``.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from tpuir_torch import zoo
from tpuir_torch.core.engine import run_model_inference
from tpuir_torch.core.metrics import calculate_metrics
from tpuir_torch.utils.profiling import ENGINE_REQUESTS, write_seeded_checkpoint

# tpuir's family names -> the model of utils.profiling.ENGINE_REQUESTS
# whose zoo route and seeded checkpoint they use
FAMILIES = {
    "DnCNN": "dncnn", "REDNet": "rednet", "DeblurGANv2-MobileNet": "deblurgan-mobilenet",
    "DeblurGANv2-Inception": "deblurgan-inception", "Restormer": "restormer",
    "MaIR-CDN": "mair", "MaIRUNet": "mairunet",
}
HEAD_SCALE = 0.05


def delta_stats(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    rng = 65535.0 if a.dtype == np.uint16 else 255.0
    mse = float(np.mean(d**2))
    return {
        "max_lsb": int(np.abs(d).max()),
        "frac_nonzero": round(float((np.abs(d) > 0).mean()), 5),
        "agreement_psnr_db": round(10 * np.log10(rng**2 / max(mse, 1e-12)), 2),
    }


def synthetic_image(h, w, n_channels=3, seed=3):
    """A smooth seeded uint8 image: gradients and a few discs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([yy / h, xx / w, 0.5 + 0.5 * np.sin((xx + yy) / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 4 + rng.rand() * min(h, w) / 4
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.rand(3)
    img = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    if n_channels == 1:
        g = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        return g.round().astype(np.uint8)[:, :, None]
    return img


def _models(key, weights_dir, device):
    """{precision: model} of family ``key`` from ``weights_dir``."""
    (task, subtask, name, gray, sigma), _, _ = ENGINE_REQUESTS[key]
    return {p: zoo.get_model_instance(task, subtask, name, gray=gray, sigma=sigma,
                                      weights_dir=weights_dir, precision=p, device=device)
            for p in ("parity", "serving")}


def seeded_models(key, device, head_scale=None):
    with tempfile.TemporaryDirectory(prefix="tpuir_torch_serving_") as wdir:
        write_seeded_checkpoint(key, wdir, seed=10, head_scale=head_scale)
        return _models(key, wdir, device)


def family_deltas(key, img, device):
    models = seeded_models(key, device)
    outs = {p: run_model_inference(m, img)[0] for p, m in models.items()}
    ms = {p: run_model_inference(m, img)[1] for p, m in models.items()}
    return {**delta_stats(outs["parity"], outs["serving"]),
            "parity_ms": round(ms["parity"], 1), "serving_ms": round(ms["serving"], 1)}


def family_trained_like(key, clean, weights_dir, device):
    try:
        models, weights = _models(key, weights_dir, device), "released"
    except FileNotFoundError:
        models = seeded_models(key, device, HEAD_SCALE)
        weights = f"seeded, head scaled by {HEAD_SCALE}"
    task, _, _, _, sigma = ENGINE_REQUESTS[key][0]
    noise = (sigma or 25) if task == "denoising" else None  # real noise: tpuir's 25
    outs = {p: run_model_inference(m, clean, need_degradation=noise is not None,
                                   noise_level=noise)[0] for p, m in models.items()}
    psnr = {p: float(calculate_metrics(o, clean)[0]) for p, o in outs.items()}
    return {**delta_stats(outs["parity"], outs["serving"]),
            "psnr_parity_db": round(psnr["parity"], 4),
            "psnr_serving_db": round(psnr["serving"], 4),
            "psnr_delta_db": round(psnr["parity"] - psnr["serving"], 4),
            "weights": weights, "sigma": noise}


def validate(families, weights_dir, size=(256, 320), device="cuda"):
    """The JSON record described in the module docstring."""
    dev = torch.device(device)
    backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    results = {"backend": backend, "weights": "random", "deltas": {}, "trained_like": {}}
    for fam in families:
        key = FAMILIES[fam]
        img = synthetic_image(*size, n_channels=1 if ENGINE_REQUESTS[key][0][3] else 3)
        results["deltas"][fam] = family_deltas(key, img, dev)
        print(f"{fam:25s} {results['deltas'][fam]}", flush=True)
        results["trained_like"][fam] = family_trained_like(key, img, weights_dir, dev)
        print(f"trained-like {fam:12s} {results['trained_like'][fam]}", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights-dir", default=None)
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated, of: " + ", ".join(FAMILIES))
    ap.add_argument("--size", default="256x320", help="the synthetic image's HxW")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("results", "serving_deltas_torch.json"))
    args = ap.parse_args(argv)
    families = args.families.split(",")
    bad = [f for f in families if f not in FAMILIES]
    if bad:
        ap.error(f"unknown families {bad}")
    size = tuple(int(v) for v in args.size.split("x"))
    results = validate(families, args.weights_dir or zoo.ROOT_WEIGHTS_DIR, size, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"written {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
